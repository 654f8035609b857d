"""Roofline terms of a dry-run step on the H100 — no card required.

The port of the JAX package's ``launch/roofline.py``, with the constants
of one NVIDIA H100 SXM5 card:

  PEAK_FLOPS  989·10¹² dense bf16 FLOP/s (the bound `chip_smoke.py` holds
              the kernels to)
  HBM_BW      3.35·10¹² B/s
  LINK_BW     450·10⁹ B/s, NVLink 4 per direction

An axis wider than one 8-card NVLink node crosses InfiniBand (≈ 50 GB/s a
card), so ``collective_s`` is a lower bound, as the JAX package's is.

The dry run (`repro_torch.launch.dryrun`) measures rank 0's local program,
so the three terms come out per device:

    compute_s    = flops / PEAK_FLOPS
    memory_s     = bytes_accessed / HBM_BW
    collective_s = collective_bytes / LINK_BW

`collective_bytes` sums the operand bytes of the collectives the step
issued, per kind, from the record `repro_torch.sharding.collectives`
keeps (ring-hop multipliers are not modelled: the term is a lower bound
and says which cells are collective-bound).

MODEL_FLOPS uses 6·N·D (dense) / 6·N_active·D (MoE) per trained token and
2·N·D per generated/prefilled token; the ratio MODEL_FLOPS / (flops·chips)
exposes remat/dispatch/padding waste.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "Roofline",
           "collective_bytes", "build_roofline"]

PEAK_FLOPS = 989e12  # dense bf16 / card
HBM_BW = 3.35e12  # bytes/s / card
LINK_BW = 450e9  # bytes/s / card, NVLink 4, one direction

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(record) -> dict[str, int]:
    """Operand bytes per collective kind of ``record`` (``(kind, bytes)``
    pairs, or the ``(kind, bytes, label)`` entries
    `repro_torch.sharding.collectives.recording` collects)."""
    out = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes, *_ in record:
        out[kind] += int(nbytes)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict[str, int]
    peak_memory_per_device: float
    model_flops: float  # 6·N_active·D (train) / 2·N_active·tokens (serve)
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time estimate: max of the three overlapping terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_s
        return (self.model_flops / (self.chips * PEAK_FLOPS) / t) if t else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_s=self.step_s,
                 useful_flops_fraction=self.useful_flops_fraction,
                 mfu=self.mfu)
        return d


def build_roofline(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: dict, peak_memory: float, model_flops: float,
                   record=None, coll: dict[str, int] | None = None) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    if coll is None:
        coll = collective_bytes(record or ())
    coll_total = float(sum(coll.values()))
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=coll_total, coll_breakdown=coll,
        peak_memory_per_device=peak_memory, model_flops=model_flops,
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll_total / LINK_BW,
    )
