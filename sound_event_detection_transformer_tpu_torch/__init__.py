"""PyTorch / CUDA port of the SEDT framework, beside the JAX package.

Ported so far: the evaluation step (the SEDT forward, the set criterion with
its Hungarian solve and the fusion post-processing) and ``predict`` on clips
of any length: the waveform -> log-mel frontend, the forward with
flash attention for long key sequences, the event decoding and the CLI
(``predict_cli``).  The hand-written CUDA kernels live in ``csrc/``: the three
Hungarian kernels K1, K2 and K3 (``hungarian_jv.cu``) and the flash-attention
forward K4 (``flash_attention.cu``).  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
