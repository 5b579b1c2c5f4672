"""PyTorch / CUDA port of the SEDT framework, beside the JAX package.

Slice 1 covers the evaluation step: the SEDT forward, the set criterion with
its Hungarian solve (kernel K1, ``csrc/hungarian_jv.cu``) and the fusion
post-processing.  Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""
