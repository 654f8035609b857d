"""repro_torch — FiGaRo (QR, SVD, PCA and least squares over database joins)
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `repro`, which stays the reference. This package
imports neither JAX nor anything of `repro`. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run instead. Start at `repro_torch.figaro`.
"""
