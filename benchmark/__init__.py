"""The benchmark of the PyTorch port: ``python benchmark/run.py``."""
