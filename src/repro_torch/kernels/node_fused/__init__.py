"""Fused per-node FiGaRo pass: mask + segmented head/tail + φ-scale + emit.

One single-pass CUDA scan (after an O(K) kernel that marks each segment's
last row) per head/tail pass of a join-tree node, two passes per node — see
`kernel.py`, ``csrc/node_fused.cu`` and ``csrc/seg_scan.cuh`` for the kernel,
`ops.py` for the public `fused_node_pass`, `ref.py` for the plain PyTorch
versions the CPU path and the tests use.
"""

from .ops import fused_node_pass, node_fused
from .ref import fused_node_pass_ref, node_fused_ref

__all__ = ["fused_node_pass", "node_fused", "fused_node_pass_ref",
           "node_fused_ref"]
