"""The collectives of the sharded LM step, each noted in the active records.

The sharded train step (`repro_torch.sharding.placement`) issues every
collective it runs through these wrappers: an all-gather along a dim, a
reduce-scatter along a dim, an all-reduce. Each one appends ``(kind,
operand bytes)`` to every record opened by `recording`, under the JAX
package's kind names (``all-gather``, ``reduce-scatter``, ``all-reduce``);
`repro_torch.launch.roofline.collective_bytes` sums them per kind, as the
JAX package sums the operands of its partitioned HLO. The operand of an
all-gather is the rank's piece, of a reduce-scatter the whole input, of an
all-reduce the tensor. A group of one rank issues nothing and notes
nothing.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["recording", "all_gather_dim", "reduce_scatter_dim",
           "all_reduce"]

_RECORDS: list[list] = []  # the records `recording` holds open


@contextlib.contextmanager
def recording():
    """A list that every collective issued inside the block appends
    ``(kind, operand bytes)`` to."""
    record: list = []
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


def _note(kind: str, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    for record in _RECORDS:
        record.append((kind, nbytes))


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` (equal shapes) concatenated along ``dim`` in
    the group's rank order."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _note("all-gather", x)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group,
                       n: int) -> torch.Tensor:
    """``t``'s ``dim`` (of size ``n``) summed over the group's ranks, each
    rank keeping its own index of it: the result drops ``dim``."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _note("reduce-scatter", x)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out.reshape(-1), x.reshape(-1), group=group)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place; returns ``t``."""
    import torch.distributed as dist

    _note("all-reduce", t)
    dist.all_reduce(t, group=group)
    return t
