"""Where a decode cache lives over a mesh, and how a layer reads and writes
its rank's part of it.

`cache_specs` is the JAX package's table: the partition spec of every leaf
of a cache over a mesh. `CacheLayout` ties a cache to an `AxisMesh`: for
every leaf of the full cache, the slice this rank holds (each dim's entry
cut as `repro_torch.sharding.rules.shard_bounds` cuts it; an axis of one
rank splits nothing). `Transformer.init_cache(layout=)` allocates the
rank's slices, `CacheLayout.gather` makes the full tree again (on every
rank, collectively), and `CacheLayout.split` gives one sub-layer's cache
kind as its layer sees it: a `CacheSplit`, the per-layer leaves' dims
(the stacked dim dropped) with the axes each is split over and this
rank's part. Without a mesh every leaf is whole (`TRIVIAL_SPLIT`), and the
layers run the same code.

The layout is JAX's; the layers adapt to it:

  * attention's ``k``/``v`` [B, S, Hkv, hd]: the kv heads over ``model``
    where they divide it (the rank's own kv heads, as training splits
    them), else the slots over ``model`` (``kv_seq_over_model``), else the
    head dim over ``model``; under ``shard_seq`` (batch 1) the slots also
    over ``data``. The ``pos`` leaf [S] is whole on every rank. Attention
    over split slots combines the online softmax's statistics over the
    slot group (`CacheSplit.reduce`); over a split head dim it sums the
    logits over ``model`` and gathers its output columns. The cross
    caches follow the same rules.
  * mamba's ``conv`` [B, w, di] and ``ssm`` [B, di, N], RWKV's ``state``
    [B, h, hd, hd]: over ``model`` on the channels (heads) the layer
    computes on, where ``_fit`` keeps the split.

Leaves a layer gathers at use, because their split falls off the unit the
layer computes on (`CacheSplit.part` gathers, `CacheSplit.put` writes back
the rank's own slice):

  * RWKV's and the channel mix's ``shift`` [B, 1, d]: split over d, while
    both mixes read every channel of the previous token;
  * mamba's ``conv`` and ``ssm`` and RWKV's ``state`` where ``_fit``
    dropped their split (the dim does not divide ``model``) but the layer
    still computes its part: the leaf is whole, so the layer gathers its
    new part over ``model`` and writes the whole leaf.
"""

from __future__ import annotations

import math

import torch

from .collectives import all_gather_dim, all_reduce

# The rules import the model, whose layers import this module: they are
# imported where they are used.

__all__ = ["cache_specs", "CacheLayout", "CacheSplit", "TRIVIAL_SPLIT"]


def cache_specs(cfg, mesh, cache: dict, *, shard_seq: bool = False,
                kv_seq_over_model: bool = True):
    """The partition spec of every leaf of ``cache`` (`Transformer.
    init_cache`'s ``{"pos<j>": {<kind>: {<leaf>: …}}}``, or a prefill's
    ``{"blocks": …, "pos": …}``; leaves, or their shapes, stacked over the
    super-blocks) over ``mesh`` (anything with a ``shape``, or a dict), as
    a tree of the same keys: JAX's ``cache_specs``.

    Batch-sharded by default; ``shard_seq`` shards attention KV slots over
    `data` (long_500k, global_batch=1). SSM states are O(1) in seq — they
    stay batch-sharded (or replicated at batch 1). ``kv_seq_over_model``:
    when the kv-head count does not divide the model axis (all assigned
    archs: kv=8 < 16), the KV slots shard over `model`; otherwise the
    head_dim does. A sharding that does not divide its dim evenly is
    dropped (JAX's ``_fit``)."""
    from .rules import P, data_axes, mesh_shape

    shape = mesh_shape(mesh)
    dp = data_axes(mesh)
    msz = shape.get("model", 1)
    kv_ax = "model" if cfg.n_kv_heads % msz == 0 else None
    seq_model_ax = None
    if kv_ax is None and kv_seq_over_model:
        hd_ax = None
        seq_model_ax = "model"
    else:
        hd_ax = None if kv_ax else "model"

    def _fit(spec, dims):
        fixed = []
        for dim, ax in zip(dims, tuple(spec) + (None,) * len(dims)):
            if ax is None:
                fixed.append(None)
                continue
            size = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                size *= shape[a]
            fixed.append(ax if dim >= size and dim % size == 0 else None)
        return P(*fixed)

    def spec(name: str, dims) -> P:
        ndim = len(dims)
        if name == "pos":
            return P()
        batch_ax = None if shard_seq else dp
        if name in ("k", "v"):  # [n_blocks, B, S, kv, hd]
            if shard_seq:  # batch == 1: context parallelism over data(+model)
                seq_ax = ("data", "model") if seq_model_ax else "data"
            else:
                seq_ax = seq_model_ax
            return _fit(P(None, batch_ax, seq_ax, kv_ax, hd_ax), dims)
        if name in ("conv", "shift"):  # [n_blocks, B, w, di]
            return _fit(P(None, batch_ax, None, "model"), dims)
        if name == "ssm":  # [n_blocks, B, di, d_state]
            return _fit(P(None, batch_ax, "model", None), dims)
        if name == "state":  # rwkv [n_blocks, B, h, hd, hd]
            return _fit(P(None, batch_ax, "model", None, None), dims)
        return P(*([None] * ndim))

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return spec(name, tuple(getattr(node, "shape", node)))

    return walk(cache, "")


class CacheSplit:
    """One sub-layer's cache kind over a mesh as its layer sees it.

    ``spans`` maps a leaf name to one entry per dim of the per-layer leaf
    (the stacked dim dropped): None where the dim is whole on this rank,
    else ``(axes, lo, hi, full)``, the axes (of more than one rank, major
    first) it is split over and the part [lo, hi) of ``full`` this rank
    holds. `TRIVIAL_SPLIT`, without a mesh, splits nothing, and its
    collectives are the identity. A layer decides by `split`, never by
    the size of its part, so every rank issues the same collectives."""

    def __init__(self, mesh=None, spans: dict | None = None):
        self.mesh = mesh
        self.spans = dict(spans or {})

    def split(self, leaf: str, dim: int) -> bool:
        s = self.spans.get(leaf)
        return s is not None and s[dim] is not None

    def span(self, leaf: str, dim: int, full: int) -> tuple[int, int]:
        """``(lo, hi)`` of ``leaf``'s dim ``dim`` on this rank; ``(0,
        full)`` where it is whole."""
        return self.spans[leaf][dim][1:3] if self.split(leaf, dim) \
            else (0, full)

    def full(self, leaf: str, dim: int, local: int) -> int:
        """The whole size of ``leaf``'s dim ``dim`` (``local``, the rank's
        part, where it is whole)."""
        return self.spans[leaf][dim][3] if self.split(leaf, dim) else local

    def reduce(self, t: torch.Tensor, leaf: str, dim: int,
               op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="max"``: its maximum) over the ranks that
        hold the other parts of ``leaf``'s dim ``dim``: a new tensor
        where the dim is split, ``t`` itself where it is whole."""
        if not self.split(leaf, dim):
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        for a in self.spans[leaf][dim][0]:
            all_reduce(t, self.mesh.group(a), op=op)
        return t

    def gather(self, t: torch.Tensor, leaf: str, dim: int, tdim: int, *,
               out: bool = False) -> torch.Tensor:
        """The parts of ``leaf``'s dim ``dim``, ``t``'s dim ``tdim`` on
        each rank, made whole (``t`` itself where the dim is whole).
        Labelled ``"cache:<leaf>"``, or ``"cache:<leaf>:out"`` for an
        activation split as the leaf (``out``)."""
        if not self.split(leaf, dim):
            return t
        label = f"cache:{leaf}" + (":out" if out else "")
        for a in reversed(self.spans[leaf][dim][0]):
            t = all_gather_dim(t, tdim, self.mesh.group(a),
                               self.mesh.shape[a], label)
        return t

    def part(self, t: torch.Tensor, leaf: str, dim: int, lo: int, hi: int,
             full: int) -> torch.Tensor:
        """The part [lo, hi) of ``leaf``'s dim ``dim`` (of size ``full``),
        which the layer computes on, from the rank's part ``t`` of the
        leaf: ``t`` itself where the two agree, else gathered whole and
        cut."""
        if self.split(leaf, dim):
            if self.span(leaf, dim, full) == (lo, hi):
                return t
            t = self.gather(t, leaf, dim, dim)
        return t if (lo, hi) == (0, full) else t.narrow(dim, lo, hi - lo)

    def put(self, t: torch.Tensor, leaf: str, dim: int, value, lo: int,
            hi: int, full: int, whole=None) -> None:
        """Write ``value``, the layer's part [lo, hi) of ``leaf``'s dim
        ``dim``, into the rank's part ``t`` of the leaf, in place. Where
        the two differ, ``whole(value)`` (the layer's gather over its
        ranks) makes the value whole first, and the rank keeps its
        slice."""
        l0, l1 = self.span(leaf, dim, full)
        if (l0, l1) != (lo, hi):
            if (lo, hi) != (0, full):
                value = whole(value)
            if (l0, l1) != (0, full):
                value = value.narrow(dim, l0, l1 - l0)
        t.copy_(value)


#: The split of a cache outside any mesh: every leaf whole.
TRIVIAL_SPLIT = CacheSplit()


class CacheLayout:
    """The slice of every leaf of a cache that this rank of ``mesh`` holds
    under `cache_specs`.

    ``shapes`` is the full cache's tree of leaf shapes (stacked over the
    super-blocks; `Transformer.cache_shapes`), ``shard_seq`` and
    ``kv_seq_over_model`` are `cache_specs`'; ``mesh`` None is this
    process alone, every leaf whole. ``rows`` is the number of data ranks
    the batch's rows split over (1 under ``shard_seq``: every rank holds
    the one sequence)."""

    def __init__(self, cfg, mesh, shapes: dict, *, shard_seq: bool = False,
                 kv_seq_over_model: bool = True):
        self.mesh = mesh
        self.shard_seq = shard_seq
        self.kv_seq_over_model = kv_seq_over_model
        self.shapes = shapes
        self.rows = self.rows_of(mesh, shard_seq)
        self._spans: dict = {}
        if mesh is None or mesh.size == 1:
            return
        specs = cache_specs(cfg, mesh, shapes, shard_seq=shard_seq,
                            kv_seq_over_model=kv_seq_over_model)
        for j, kinds in shapes["blocks"].items():
            for kind, leaves in kinds.items():
                for name, shape in leaves.items():
                    spec = tuple(specs["blocks"][j][kind][name])
                    spec += (None,) * (len(shape) - len(spec))
                    self._spans[(j, kind, name)] = tuple(
                        self._span(dim, entry)
                        for dim, entry in zip(shape, spec))

    @staticmethod
    def rows_of(mesh, shard_seq: bool) -> int:
        """The data ranks a batch's rows split over on ``mesh``."""
        from .rules import data_axes

        if mesh is None or shard_seq:
            return 1
        return math.prod(mesh.shape[a] for a in data_axes(mesh))

    def _span(self, dim: int, entry):
        from .rules import shard_bounds, spec_axes

        axes = tuple(a for a in spec_axes(entry) if self.mesh.shape[a] > 1)
        if not axes:
            return None
        lo, hi, _ = shard_bounds(dim, axes, self.mesh.shape,
                                 self.mesh.coords)
        return (axes, lo, hi, dim)

    def local_shape(self, j: str, kind: str, name: str) -> tuple[int, ...]:
        """The shape of this rank's slice of the leaf (stacked)."""
        shape = self.shapes["blocks"][j][kind][name]
        spans = self._spans.get((j, kind, name))
        if spans is None:
            return tuple(shape)
        return tuple(n if s is None else s[2] - s[1]
                     for n, s in zip(shape, spans))

    def split(self, j: str, kind: str) -> CacheSplit:
        """Sub-layer ``j``'s cache kind ``kind`` as its layer sees it."""
        if not self._spans:
            return TRIVIAL_SPLIT
        spans = {name: self._spans[(j, kind, name)][1:]
                 for name in self.shapes["blocks"][j][kind]
                 if (j, kind, name) in self._spans}
        if not any(s is not None for per in spans.values() for s in per):
            return TRIVIAL_SPLIT
        return CacheSplit(self.mesh, spans)

    def gather(self, cache: dict) -> dict:
        """The full cache (JAX's layout, new tensors) from every rank's
        ``cache`` (``{"blocks": …, "pos": …}``): collective, every rank
        calls it and gets the whole tree."""
        blocks = {}
        for j, kinds in cache["blocks"].items():
            blocks[j] = {}
            for kind, leaves in kinds.items():
                blocks[j][kind] = {}
                for name, t in leaves.items():
                    spans = self._spans.get((j, kind, name)) or ()
                    for dim, s in enumerate(spans):
                        if s is None:
                            continue
                        for a in reversed(s[0]):
                            t = all_gather_dim(t, dim, self.mesh.group(a),
                                               self.mesh.shape[a])
                    blocks[j][kind][name] = t.clone()
        return {"blocks": blocks, "pos": cache["pos"].clone()}


class ServeCache(dict):
    """A cache tree (``{"blocks": …, "pos": …}``, JAX's keys) with the
    `CacheLayout` its leaves are sliced by (``layout``)."""

    def __init__(self, tree: dict, layout: CacheLayout):
        super().__init__(tree)
        self.layout = layout
