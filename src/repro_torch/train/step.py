"""The LM's train and eval steps, on one device or over a mesh of ranks.

The port of the JAX package's ``train/step.py``. `TrainState` holds the
`Transformer` itself (its ``nn.Parameter``s are the parameters), AdamW's
state (`repro_torch.optim.adamw_init`), the step and, over a mesh, the
`Placement` of its slices; `make_train_step`'s step runs the forward and
autograd's backward, optionally over sequential micro-steps with float32
gradient accumulation, optionally the TSQR-orthogonalized update, then
AdamW, writing the parameters, the moments and the step in place.

``mesh`` is None (this device alone) or an `AxisMesh`
(`repro_torch.launch.mesh.make_host_mesh`, `make_production_mesh`). Over a
mesh each rank holds its slice of every parameter, moment and gradient
(`shard_state`, `init_state(mesh=)`: JAX's ``param_shardings``, FSDP over
``data`` where ``cfg.fsdp``); the step gathers each super-block's
parameters over the data axes just before the block runs (again under
remat), reduces the gradients over the data axes into the rank's slices
(reduce-scatter where the spec names ``data``) and runs AdamW on the
slices. Rank r of the data axes takes the r-th contiguous block of the
global batch's rows (``batch_specs``); the ``model`` axis's ranks split
the compute of those rows, each layer on its part of the layout
(`repro_torch.sharding.placement`: attention heads or rows of d, MLP and
expert columns, experts, d_inner, vocab), the loss vocab-parallel. A mesh
of one rank runs this same code, with nothing to gather, split or reduce.
The step computes JAX's one-device step on the global batch: the loss over
the global token count, the MoE layers' aux and capacity over the global
tokens (`repro_torch.models.moe`), the gradient norm with each element
counted once, the orthogonal update on each leaf's full gradient; the
metrics are the global batch's; over a mesh of one rank they are the
mesh-less step's, bit for bit. The flash-attention branch has no backward
(`models.layers.FLASH_NO_BACKWARD`), so a train step refuses
``use_flash_kernel=True``. `make_eval_step` runs the same forward over a
mesh (the flash branch on each rank's heads), and gives the global batch's
metrics and, when asked, JAX's logits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels._platform import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import FLASH_NO_BACKWARD
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.orthogonal import orthogonalized_update
from repro_torch.sharding.placement import Placement
from repro_torch.sharding.rules import batch_specs, shard_bounds

__all__ = ["TrainState", "init_state", "shard_state", "make_train_step",
           "make_eval_step"]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), AdamW's state and the step (a 0-d int32
    tensor on the model's device); a train step updates all three in
    place."""
    model: Transformer
    opt_state: dict
    step: torch.Tensor
    placement: Placement | None = None


def init_state(generator: torch.Generator, cfg: ModelConfig,
               opt_cfg: AdamWConfig, device=None, mesh=None) -> TrainState:
    """A randomly initialized model (`Transformer.init` from ``generator``,
    which must live on ``device``), zero moments and step 0 on ``device``
    (the card unless the caller names another; a ``mesh`` names its own).
    Over a ``mesh`` every rank draws the full model from the same seed
    and keeps its slices (`shard_state`)."""
    if mesh is not None:
        device = mesh.check_device(device)
    device = resolve_device(device)
    model = Transformer(cfg, device=device).init(generator)
    state = TrainState(model=model, opt_state=adamw_init(model, opt_cfg),
                       step=torch.zeros((), dtype=torch.int32, device=device))
    return state if mesh is None else shard_state(state, mesh)


def shard_state(state: TrainState, mesh) -> TrainState:
    """``state`` (full parameters and moments) reduced, in place, to the
    slices this rank of ``mesh`` holds under the model's rules; returns
    it with its `Placement`. On a mesh of one rank nothing moves."""
    if state.placement is not None:
        raise ValueError("the state is sharded already")
    place = Placement(state.model.cfg, mesh, state.model)
    place.shard(state.model, state.opt_state)
    state.placement = state.model.placement = place
    return state


def _to_device(batch, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _check_mesh(mesh, device) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    if not hasattr(mesh, "axes"):
        raise TypeError(f"the mesh is an AxisMesh (launch.mesh."
                        f"make_host_mesh or make_production_mesh), not a "
                        f"{type(mesh).__name__}")
    return mesh.check_device(device)


def _rows(batch: dict, place: Placement | None) -> dict:
    """This rank's block of the global batch's rows, as `batch_specs`
    splits them over the data axes."""
    if place is None:
        return batch
    mesh, specs = place.mesh, batch_specs(place.cfg, place.mesh)
    d = place.data.size
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % d:
            raise ValueError(f"a global batch of {b} rows does not split "
                             f"over {d} data ranks")
        rows = shard_bounds(b, specs[k][0], mesh.shape, mesh.coords)
        out[k] = v[rows[0]:rows[1]]
    return out


def _placement(state: TrainState, mesh) -> Placement | None:
    """The state's placement over ``mesh`` (None without a mesh: the
    mesh-less step)."""
    place = state.placement
    if mesh is None:
        if place is not None and place.mesh.size > 1:
            raise ValueError("the state is sharded over another mesh")
        return None
    if place is None or place.mesh is not mesh:
        raise ValueError(f"the state is not sharded over this mesh of "
                         f"{mesh.size} ranks: make it with init_state(mesh=) "
                         f"or shard_state")
    return place


def _orthogonalized(grads: dict, model, place: Placement | None) -> dict:
    """The orthogonal update on each stacked leaf's full gradient (gathered
    over the mesh), every rank keeping its slices."""
    if place is None:
        return orthogonalized_update(grads, model=model)
    from repro_torch.models.weights import jax_path

    groups: dict = {}
    for name in grads:
        groups.setdefault(jax_path(name), []).append(name)
    out = {}
    for names in groups.values():
        full = {n: place.full(n, grads[n]) for n in names}
        for n, g in orthogonalized_update(full, model=model).items():
            out[n] = place.local(n, g)
    return {n: out[n] for n in grads}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh=None,
    *,
    microbatch: int | None = None,
    orthogonal_update: bool = False,
    device=None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``step_fn(state, batch) -> (state, metrics)``: forward, backward and
    the AdamW update of ``state`` in place (the same state comes back, its
    step one higher), on ``device`` (the card unless ``device="cpu"``; a
    ``mesh`` names its own, and the state must be sharded over it). Every
    rank of a mesh is given the global batch. ``batch`` maps ``"tokens"`` (and
    optionally ``"loss_mask"``) to [B, S] arrays or tensors, and holds the
    ``"frames"`` [B, T, d] of an encoder-decoder or the ``"patches"`` [B,
    P, d] of a patch config.

    ``microbatch``: split the batch into this many sequential micro-steps,
    row ``j*microbatch + m`` to micro-step ``m`` (JAX's reshape and swap);
    the gradient is the mean of theirs, accumulated in float32, the loss
    the mean of theirs, the other metrics the last micro-step's. Over a
    mesh a micro-step's rows are rank-local only when the rows per data
    rank split into ``microbatch``; otherwise it raises.
    ``orthogonal_update``: TSQR-orthogonalize the gradients
    (`repro_torch.optim.orthogonalized_update`, judged as JAX's stacked
    leaves). ``metrics`` is JAX's ``dict(ce, aux, zloss, tokens, loss,
    grad_norm, lr)`` of 0-d tensors on the device."""
    if cfg.use_flash_kernel:
        raise NotImplementedError(f"make_train_step: {FLASH_NO_BACKWARD}")
    dev = _check_mesh(mesh, device)

    def grads_of(model, batch, place):
        if place is None:
            loss, metrics = model.loss_fn(batch, cfg)
            loss.backward()
        else:
            with place.bind(model):
                loss, metrics = model.loss_fn(batch, cfg,
                                              sum_over=place.data.sum)
                loss.backward()
            loss = metrics["ce"] + metrics["zloss"] + metrics["aux"]
        grads = {}
        for name, p in model.named_parameters():
            grads[name], p.grad = p.grad, None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        place = _placement(state, mesh)
        batch = _to_device(_rows(batch, place), dev)
        model = state.model
        with torch.enable_grad():
            if microbatch and microbatch > 1:
                b = batch["tokens"].shape[0]
                if b % microbatch:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatch} micro-steps")
                gsum, lsum = None, 0.0
                for m in range(microbatch):
                    mb = {k: v.reshape((b // microbatch, microbatch)
                                       + v.shape[1:])[:, m]
                          for k, v in batch.items()}
                    loss, metrics, g = grads_of(model, mb, place)
                    if gsum is None:
                        gsum = {n: x.to(torch.float32, copy=True)
                                for n, x in g.items()}
                    else:
                        for n, x in g.items():
                            gsum[n] += x.float()
                    lsum = lsum + loss
                    del g
                grads = {n: x / microbatch for n, x in gsum.items()}
                del gsum
                loss = lsum / microbatch
            else:
                loss, metrics, grads = grads_of(model, batch, place)
        if orthogonal_update:
            grads = _orthogonalized(grads, model, place)
        norm = None if place is None else place.grad_norm(grads)
        _, _, opt_metrics = adamw_update(grads, state.opt_state, model,
                                         opt_cfg, grad_norm=norm)
        del grads
        state.step.add_(1)
        return state, dict(metrics, loss=loss, **opt_metrics)

    return step_fn


def make_eval_step(cfg: ModelConfig, device=None, mesh=None, *,
                   logits: bool = False) -> Callable:
    """``eval_fn(model, batch) -> dict(metrics, loss=loss)`` for a
    `repro_torch.models.transformer.Transformer` on ``device`` (the card
    unless ``device="cpu"``), or, over a ``mesh``, for the `TrainState`
    sharded over it (a mesh names its own device; every rank is given the
    global batch). ``batch`` maps ``"tokens"`` (and optionally
    ``"loss_mask"``) to [B, S] arrays or tensors, with ``"frames"`` or
    ``"patches"`` as `make_train_step`'s; they are moved to the device. The
    forward runs under ``cfg`` — with ``cfg.use_flash_kernel`` its
    attention goes through the flash-attention kernel. The metrics are
    the global batch's; ``logits=True`` adds ``"logits"``, the global
    batch's [B, S, padded_vocab] float32 logits (JAX's ``forward``'s)."""
    dev = _check_mesh(mesh, device)

    def eval_fn(model, batch):
        place = None
        if isinstance(model, TrainState):
            place = _placement(model, mesh)
            model = model.model
        elif mesh is not None:
            raise TypeError("over a mesh, eval the TrainState sharded over "
                            "it (init_state(mesh=) or shard_state)")
        batch = _to_device(_rows(batch, place), dev)
        with torch.inference_mode():
            if place is None:
                loss, metrics = model.loss_fn(batch, cfg, logits=logits)
            else:
                with place.bind(model):
                    _, metrics = model.loss_fn(batch, cfg, logits=logits,
                                               sum_over=place.data.sum)
                loss = metrics["ce"] + metrics["zloss"] + metrics["aux"]
                if logits:
                    metrics["logits"] = place.data.gather(
                        metrics["logits"]).flatten(0, 1)
        return dict(metrics, loss=loss)

    return eval_fn
