"""Peaks of one NVIDIA H100 SXM and the work of FiGaRo's two kernel layers.

The counts are of the operation, not of the kernels that carry it out, so a
roofline share reads the same whatever implements the layer. Sizes are the
live sizes of the join (`figbench.data.tree_stats`), never the capacities a
plan pads to.

- The node pass (Algorithm 2, one pass a relation): each relation's data leaf
  [m, n] is read once, and its slab of R₀ written once: its m scaled tail
  rows over its own n columns and its K generalized-tail (for the root: head)
  rows over the w columns of its subtree. The arithmetic is a few operations
  an element (the segmented sums, the scaling, the norms), counted as 8.
- The postprocess (R₀ → R): R₀'s M = Σ (m + K) live rows of N columns are
  read once and R [N, N] is written once; Householder QR of M × N takes
  2MN² − 2N³/3 operations.
"""

from __future__ import annotations

#: NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 67e12}
ELEM_BYTES = {"float32": 4, "float64": 8}

__all__ = ["HBM_BYTES_PER_S", "FLOPS_PER_S", "ELEM_BYTES", "node_pass_work",
           "panel_work", "least_seconds"]


def node_pass_work(stats: dict, dtype: str) -> tuple[int, int]:
    """(bytes, flops) of one request's node passes."""
    e = ELEM_BYTES[dtype]
    nbytes = flops = 0
    for s in stats["nodes"].values():
        nbytes += e * (2 * s["m"] * s["n"] + s["K"] * s["w"])
        flops += 8 * s["m"] * s["n"]
    return nbytes, flops


def panel_work(stats: dict, dtype: str) -> tuple[int, int]:
    """(bytes, flops) of one request's R₀ → R."""
    e = ELEM_BYTES[dtype]
    n = stats["N"]
    m = sum(s["m"] + s["K"] for s in stats["nodes"].values())
    return e * (m * n + n * n), int(2 * m * n * n - 2 * n ** 3 / 3)


def least_seconds(work: tuple[int, int], dtype: str) -> float:
    """The least time of ``(bytes, flops)`` on the card: the larger of the
    bytes over the memory bandwidth and the operations over the peak."""
    nbytes, flops = work
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype])
