"""The collectives of the sharded LM step, each noted in the active records.

The sharded train step (`repro_torch.sharding.placement`) and the layers'
compute split over the mesh's ``model`` axis issue every collective they
run through these wrappers: an all-gather along a dim, a reduce-scatter
along a dim, an all-reduce (a sum, or a max). Each one appends ``(kind,
operand bytes)`` to every record opened by `recording`, under the JAX
package's kind names (``all-gather``, ``reduce-scatter``, ``all-reduce``);
`repro_torch.launch.roofline.collective_bytes` sums them per kind, as the
JAX package sums the operands of its partitioned HLO. The operand of an
all-gather is the rank's piece, of a reduce-scatter the whole input, of an
all-reduce the tensor. A group of one rank issues nothing and notes
nothing. Each entry is ``(kind, operand bytes, label)``: an all-gather of
a parameter is labelled ``"<axis>:<name>"`` (`ModelAxis.gather` says how
it labels its own), every other collective None.

`ModelAxis` is the ``model`` axis as a layer sees it (Megatron-style
tensor parallelism): its size, this rank's index, its group and the span
of each of the layer's parameters this rank holds over it, with the three
autograd collectives of the split, each the identity on an axis of one
rank:

  * `ModelAxis.copy` — identity forward, all-reduce backward: a tensor
    held alike by every model rank (an activation, or a parameter held
    whole) entering work that each rank does on its own part;
  * `ModelAxis.reduce` — all-reduce forward, identity backward: the
    partial sums of the ranks' parts made whole;
  * `ModelAxis.gather` — all-gather forward along a dim (each rank's
    piece padded to the span's chunk), this rank's slice backward.

A layer's forward keeps one rule: whatever is held alike over ``model``
enters rank-local work through ``copy``. Every gradient that reaches a
parameter held whole over ``model`` is then whole, and alike on every
model rank, so nothing is summed over ``model`` after the backward.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["recording", "pad_dim", "all_gather_dim", "reduce_scatter_dim",
           "all_reduce", "ModelAxis", "TRIVIAL"]

_RECORDS: list[list] = []  # the records `recording` holds open


@contextlib.contextmanager
def recording():
    """A list that every collective issued inside the block appends
    ``(kind, operand bytes, label)`` to."""
    record: list = []
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


def _note(kind: str, t: torch.Tensor, label: str | None = None) -> None:
    nbytes = t.numel() * t.element_size()
    for record in _RECORDS:
        record.append((kind, nbytes, label))


def pad_dim(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` padded with zeros at the end of ``dim`` to ``size`` (itself
    where it is that long)."""
    if t.shape[dim] >= size:
        return t
    pad = list(t.shape)
    pad[dim] = size - t.shape[dim]
    return torch.cat([t, t.new_zeros(pad)], dim=dim)


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int,
                   label: str | None = None) -> torch.Tensor:
    """The ``n`` ranks' ``t`` (equal shapes) concatenated along ``dim`` in
    the group's rank order."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _note("all-gather", x, label)
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


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="max"``: its maximum taken) over the group's
    ranks, in place; returns ``t``."""
    import torch.distributed as dist

    _note("all-reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return t


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, ctx.axis.group), None


class _Reduce(torch.autograd.Function):
    """The ranks' partial sums summed forward; identity backward."""

    @staticmethod
    def forward(ctx, t, axis):
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          axis.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    """The ranks' pieces along ``dim`` (each padded to ``chunk``) gathered
    and cut to ``full``; backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, t, axis, dim, chunk, full, label):
        ctx.dim = dim
        ctx.lo = min(full, axis.index * chunk)
        ctx.n = t.shape[dim]
        out = all_gather_dim(pad_dim(t, dim, chunk), dim, axis.group,
                             axis.size, label)
        return out.narrow(dim, 0, full)

    @staticmethod
    def backward(ctx, grad):
        g = grad.narrow(ctx.dim, ctx.lo, ctx.n).contiguous()
        return g, None, None, None, None, None


class ModelAxis:
    """The mesh's ``model`` axis as one layer sees it: ``size`` ranks, this
    rank's ``index``, the axis's process ``group``, and ``spans``: for
    each of the layer's parameters (by leaf name), per dim split over
    ``model``, ``(lo, hi, chunk, full)`` — the part [lo, hi) of the full
    dim ``full`` this rank holds (its data slices gathered) and the padded
    ``chunk`` every rank's part gathers at; None for a dim not split.
    ``prefix`` is the layer's module name, which labels its gathers. The
    default, `TRIVIAL`, is an axis of one rank (no mesh, or ``model`` =
    1): nothing split, every collective the identity. A layer decides how
    it splits by `split`, never by the size of its part, so that every
    rank issues the same collectives."""

    def __init__(self, size: int = 1, index: int = 0, group=None,
                 spans: dict | None = None, prefix: str = ""):
        self.size, self.index, self.group = size, index, group
        self.spans = dict(spans or {})
        self.prefix = prefix

    @property
    def trivial(self) -> bool:
        return self.size == 1

    def split(self, leaf: str, dim: int) -> bool:
        """Whether ``leaf``'s dim ``dim`` is split over the axis (a rank's
        part may still be all of it, or nothing, where the dim is small)."""
        s = self.spans.get(leaf)
        return s is not None and s[dim] is not None

    def span(self, leaf: str, dim: int, full: int) -> tuple[int, int]:
        """``(lo, hi)``: the part of ``leaf``'s dim ``dim`` (of size
        ``full``) this rank holds, (0, full) where it is not split."""
        return self.spans[leaf][dim][:2] if self.split(leaf, dim) \
            else (0, full)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (held alike by the model ranks) for rank-local work: the
        backward sums its gradient over them."""
        return t if self.trivial else _Copy.apply(t, self)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the model ranks' partial ``t``."""
        return t if self.trivial else _Reduce.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int, leaf: str, leaf_dim: int,
               *, weight: bool = False) -> torch.Tensor:
        """The model ranks' parts of ``t`` along ``dim`` made whole, split
        as ``leaf``'s dim ``leaf_dim`` (``t`` is this rank's part: the
        parameter itself where ``weight``, else an activation split as it
        is); backward, this rank's slice of the gradient. Labelled
        ``"model:<name>"`` for a parameter, ``"model:<name>:out"`` for an
        activation."""
        if self.trivial:
            return t
        _, _, chunk, full = self.spans[leaf][leaf_dim]
        name = f"{self.prefix}.{leaf}" if self.prefix else leaf
        label = f"model:{name}" + ("" if weight else ":out")
        return _GatherFrom.apply(t, self, dim % t.ndim, chunk, full, label)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the model ranks (no
        gradient)."""
        t = t.detach()
        if self.trivial:
            return t
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          self.group, op="max")


#: The axis of a layer outside any mesh.
TRIVIAL = ModelAxis()
