"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version:

  node_fused/  fused per-node FiGaRo pass (mask·head/tail·φ·emit) — hot path
  panel_qr/    Householder panel factorization — post-processing hot spot

The sources live in ``repro_torch/csrc/`` and are built with nvcc at first
use (`_build`); the device policy and launch counters are in `_platform`.
"""
