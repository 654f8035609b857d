"""Where a sharded train state lives, and how its step gathers and reduces.

A `Placement` ties a `Transformer` to an `AxisMesh`: each rank holds only
its slice (`rules.param_shardings`) of every parameter, AdamW moment and
gradient. The train step (`repro_torch.train.step`) runs the model on
parameters gathered over the data axes, its compute split over ``model``,
and keeps the reduced gradients as slices:

  * **Gather.** A super-block's parameters are all-gathered over the data
    axes (``pod``, ``data``) just before the block runs (`run_block`, the
    `Transformer`'s ``block_runner``), and again when remat recomputes the
    block in the backward; the other parameters (embedding, head, final
    norm, encoder positions, patch projection) for the whole forward
    (`bind`). A dim split over several axes gathers over its data axes
    only, each rank's piece padded to the chunk ⌈dim / Π|axes|⌉: the part
    split over ``model`` (the major axis of a dim's entry) stays local,
    and the layer computes on it (`collectives.ModelAxis`, set on every
    layer by `shard`).
  * **Split.** Each layer splits its compute over ``model`` on the layout
    the rules give (Megatron-style: column- and row-parallel projections,
    heads, experts, vocab), with `ModelAxis.copy`, ``reduce`` and
    ``gather`` (`repro_torch.models`). Where a rank's part of a leaf does
    not fall on the unit its layer splits on, the layer gathers that leaf
    over ``model`` (`ModelAxis.gather`) and computes its own part: only
    the leaves of `GATHERED_OVER_MODEL`, which are

      - ``mixer.in_proj`` of a `ssm.Mamba` layer: its [d, 2·d_inner]
        columns split contiguously, so at ``model`` 2 one rank holds all
        of x and the other all of z; every rank takes its x and z columns;
      - ``mixer.wr``, ``mixer.wk``, ``mixer.wv``, ``mixer.wg`` and
        ``mixer.wo`` of a `ssm.RWKV` time mix whose heads do not divide
        ``model`` (its columns are not whole heads, so it computes whole),
        and its ``wk``, ``wv`` and ``wo`` where they match the attention's
        rules (JAX's, first in order) and those split them off its heads
        (rows of ``wk``/``wv`` where the kv heads do not divide ``model``,
        ``wo`` whole where the heads do not).

  * **Reduce.** The backward of a gather (`_Gather`) turns the gradient of
    this rank's rows and model part into the rank's slice of the sum over
    the data axes: a data axis the spec names is a reduce-scatter, one it
    does not name an all-reduce. Nothing is cut or summed over ``model``:
    the gradient arrives as the model part's own, whole and alike on every
    model rank where the leaf is held whole over ``model``.
  * **Norm.** `grad_norm` counts each element once: a slice held alike by
    several ranks (an axis its spec does not name) is counted by the one
    at coordinate 0 of those axes, then one all-reduce over every axis.

`DataAxes` carries the sums over the data axes that the loss and the MoE
layers need: the global token count, the metrics, the router's means and
the expert counts. A mesh of one rank runs the same code: its axes issue
no collective, every slice is the whole tensor, and the step computes the
mesh-less step's numbers, bit for bit.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from repro_torch.models.weights import block_index
from .collectives import (ModelAxis, all_gather_dim, all_reduce, pad_dim,
                          reduce_scatter_dim)
from .rules import data_axes, param_shardings, param_specs, spec_axes

__all__ = ["Placement", "DataAxes", "GATHERED_OVER_MODEL"]

#: The leaves a layer gathers over ``model`` (by the end of their names),
#: as the module docstring lists them.
GATHERED_OVER_MODEL = ("mixer.in_proj", "mixer.wr", "mixer.wk", "mixer.wv",
                       "mixer.wg", "mixer.wo")


class DataAxes:
    """The data axes of a mesh as one: ``size`` ranks (the product),
    this rank's ``index`` among them (``pod`` major), and the collectives
    over them."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)
        self.size = math.prod(mesh.shape[a] for a in self.axes)
        index = 0
        for a in data_axes(mesh):
            index = index * mesh.shape[a] + mesh.coords[a]
        self.index = index

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data ranks (a new tensor, no gradient)."""
        t = t.detach().clone()
        for a in self.axes:
            all_reduce(t, self.mesh.group(a))
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` stacked in data-index order: [size,
        *t.shape]."""
        x = t.detach()[None]
        for a in reversed(self.axes):
            x = all_gather_dim(x, 0, self.mesh.group(a), self.mesh.shape[a])
        return x


class _Gather(torch.autograd.Function):
    """A parameter's slice → the full tensor; backward: the full gradient
    → the slice of its sum over the data ranks."""

    @staticmethod
    def forward(ctx, shard, place, name):
        ctx.place, ctx.name = place, name
        full = place.gather_raw(name, shard)
        return full.view_as(full) if full is shard else full

    @staticmethod
    def backward(ctx, grad):
        return ctx.place.reduce(ctx.name, grad), None, None


class Placement:
    """The slices of ``model``'s parameters (full shapes) that this rank of
    ``mesh`` holds under ``cfg``'s rules; `shard` moves a full model and
    its moments to them."""

    def __init__(self, cfg, mesh, model):
        self.cfg, self.mesh = cfg, mesh
        self.shape = dict(mesh.shape)
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.specs = param_specs(cfg, mesh, model)
        self._slices = param_shardings(cfg, mesh, model, mesh.coords)
        # The padded size every rank's slice of a dim gathers at.
        self.chunks = {
            n: tuple(-(-dim // math.prod(self.shape[a]
                                         for a in spec_axes(entry)))
                     for dim, entry in zip(self.shapes[n], spec))
            for n, spec in self.specs.items()}
        # Per dim split over ``model``, (lo, hi, chunk, full) of the part
        # this rank holds over it: the model coordinate's chunks, its data
        # axes gathered (None for a dim not split over ``model``).
        self.spans = {n: tuple(self._model_span(dim, entry) for dim, entry
                               in zip(self.shapes[n], spec))
                      for n, spec in self.specs.items()}
        self.data = DataAxes(mesh)
        self._blocks: dict[int, list] = {}
        self._top: list = []

    # -- slices ---------------------------------------------------------------

    def slices(self, name: str) -> tuple[slice, ...]:
        return self._slices[name]

    def whole(self, name: str) -> bool:
        """Whether this rank's slice of ``name`` is the whole tensor."""
        return all(s.stop - s.start == dim for s, dim in
                   zip(self._slices[name], self.shapes[name]))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor ``full`` (a copy, or the
        tensor itself where the slice is whole)."""
        if self.whole(name):
            return full
        return full[self.slices(name)].clone()

    def _model_span(self, dim: int, entry):
        axes = spec_axes(entry)
        m = self.shape.get("model", 1)
        if "model" not in axes or m == 1:
            return None
        if axes[0] != "model":
            raise ValueError(f"a dim split over {axes}: ``model`` must be "
                             f"its major axis")
        rest = math.prod(self.shape[a] for a in axes[1:])
        chunk = -(-dim // (m * rest)) * rest
        lo = min(dim, self.mesh.coords["model"] * chunk)
        return (lo, min(dim, lo + chunk), chunk, dim)

    def _data_split(self, name: str, dim: int) -> tuple[str, ...]:
        """The data axes (of more than one rank) ``name``'s dim ``dim`` is
        split over, major first."""
        return tuple(a for a in spec_axes(self.specs[name][dim])
                     if a in self.data.axes)

    def owns(self, name: str) -> bool:
        """Whether this rank counts its slice of ``name`` in a norm: it is
        at coordinate 0 of every axis the spec does not name."""
        named = {a for e in self.specs[name] for a in spec_axes(e)}
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axes
                   if a not in named and self.shape[a] > 1)

    @torch.no_grad()
    def shard(self, model: nn.Module, opt_state: dict | None = None) -> None:
        """Replace ``model``'s full parameters (and ``opt_state``'s full
        moments) by this rank's slices, in place (a leaf held whole stays
        as it is), and point its MoE layers at the data axes."""
        for name, p in list(model.named_parameters()):
            if self.whole(name):
                continue
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            setattr(mod, leaf, nn.Parameter(self.local(name, p.detach()),
                                            requires_grad=p.requires_grad))
        if opt_state is not None:
            for key in ("mu", "nu"):
                opt_state[key] = {n: self.local(n, t) for n, t in
                                  opt_state[key].items()}
        group = self.mesh.group("model") if "model" in self.shape else None
        for mod_name, mod in model.named_modules():
            if hasattr(mod, "data_axes"):
                mod.data_axes = self.data
            if hasattr(mod, "tp"):
                spans = {leaf: self.spans[f"{mod_name}.{leaf}" if mod_name
                                          else leaf]
                         for leaf, _ in mod.named_parameters(recurse=False)}
                mod.tp = ModelAxis(self.shape.get("model", 1),
                                   self.mesh.coords.get("model", 0), group,
                                   spans, mod_name)

    # -- gathers and reductions ----------------------------------------------

    def gather_raw(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part over ``model`` of ``name`` (the whole tensor on
        a dim not split over ``model``) from every data rank's slice ``t``
        (no gradient)."""
        for dim, chunk in enumerate(self.chunks[name]):
            axes = self._data_split(name, dim)
            if not axes:
                continue
            t = pad_dim(t, dim, chunk)
            for a in reversed(axes):
                t = all_gather_dim(t, dim, self.mesh.group(a), self.shape[a],
                                   f"{a}:{name}")
            span = self.spans[name][dim]
            t = t.narrow(dim, 0, self.shapes[name][dim] if span is None
                         else span[1] - span[0])
        return t

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``name`` over ``model`` for the forward; its
        gradient reaches ``shard`` as the slice of the sum over the data
        ranks."""
        return _Gather.apply(shard, self, name)

    def reduce(self, name: str, grad: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``grad`` (the gradient of its rows and its
        part over ``model``) summed over the data ranks."""
        daxes = self.data.axes
        g = grad
        for dim, (sl, chunk) in enumerate(zip(self.slices(name),
                                              self.chunks[name])):
            kept = self._data_split(name, dim)
            if not kept:
                continue
            sizes = tuple(self.shape[a] for a in kept)
            g = pad_dim(g, dim, math.prod(sizes) * chunk)
            g = g.unflatten(dim, sizes + (chunk,))
            for i in reversed(range(len(kept))):
                g = reduce_scatter_dim(g, dim + i, self.mesh.group(kept[i]),
                                       self.shape[kept[i]])
            g = g.narrow(dim, 0, sl.stop - sl.start)
        named = {a for e in self.specs[name] for a in spec_axes(e)}
        rest = [a for a in daxes if a not in named]
        if rest:  # summed in a copy of its own, never in autograd's grad
            g = g.clone(memory_format=torch.contiguous_format)
            for a in rest:
                all_reduce(g, self.mesh.group(a))
        return g.contiguous()

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of ``name`` from this rank's slice ``t``, for a
        checkpoint or the orthogonal update (no gradient; collective)."""
        t = self.gather_raw(name, t.detach())
        for dim, span in enumerate(self.spans[name]):
            if span is None:
                continue
            _, _, chunk, full = span
            t = all_gather_dim(pad_dim(t, dim, chunk), dim,
                               self.mesh.group("model"), self.shape["model"],
                               f"model:{name}")
            t = t.narrow(dim, 0, full)
        return t

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """√(Σ g²) over the full gradients, each element counted once, in
        float32."""
        total = 0
        for name, g in grads.items():
            if self.owns(name):
                total = total + torch.sum(torch.square(g.float()))
        total = torch.as_tensor(total, dtype=torch.float32,
                                device=self.mesh.device).clone()
        for a in self.mesh.axes:
            if self.shape[a] > 1:
                all_reduce(total, self.mesh.group(a))
        return torch.sqrt(total)

    # -- the forward on gathered parameters ----------------------------------

    def _index(self, model: nn.Module) -> None:
        """Each super-block's and the top level's (module, leaf, name)."""
        if self._blocks or self._top:
            return
        for mod_name, mod in model.named_modules():
            for leaf, p in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                i = block_index(name)
                if i is None:
                    self._top.append((mod, leaf, name, p))
                else:
                    stack = name.split(".")[0]
                    block = getattr(model, stack)[i]
                    self._blocks.setdefault(id(block), []).append(
                        (mod, leaf, name, p))

    @contextlib.contextmanager
    def _installed(self, entries):
        for mod, leaf, name, p in entries:
            mod._parameters[leaf] = self.gather(name, p)
        try:
            yield
        finally:
            for mod, leaf, _, p in entries:
                mod._parameters[leaf] = p

    def run_block(self, block, *args, **kw):
        """`transformer._block_forward` on gathered parameters: the
        `Transformer`'s ``block_runner``."""
        from repro_torch.models.transformer import _block_forward

        with self._installed(self._blocks.get(id(block), [])):
            return _block_forward(block, *args, **kw)

    @contextlib.contextmanager
    def bind(self, model: nn.Module, rows: bool = True):
        """Run ``model`` on gathered parameters inside the block: the top
        level gathered once, each super-block when it runs. ``rows=False``
        (serving one sequence held whole by every rank, ``shard_seq``)
        leaves the MoE layers without their data axes inside the block:
        no rank holds rows of its own."""
        self._index(model)
        model.block_runner = self.run_block
        moe = [] if rows else [m for m in model.modules()
                               if getattr(m, "data_axes", None) is not None]
        for m in moe:
            m.data_axes = None
        try:
            with self._installed(self._top):
                yield
        finally:
            model.block_runner = None
            for m in moe:
                m.data_axes = self.data
