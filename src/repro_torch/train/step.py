"""The LM's train and eval steps on one device.

The port of the JAX package's ``train/step.py``. `TrainState` holds the
`Transformer` itself (its ``nn.Parameter``s are the parameters), AdamW's
state (`repro_torch.optim.adamw_init`) and the step; `make_train_step`'s
step runs the forward and autograd's backward, optionally over sequential
micro-steps with float32 gradient accumulation, optionally the
TSQR-orthogonalized update, then AdamW, writing the parameters, the moments
and the step in place. ``mesh`` is None or a one-rank
`repro_torch.launch.mesh.DataMesh`: data-parallel training across ranks
needs the gradient all-reduce that JAX gets from GSPMD (ROADMAP A14.6).
The flash-attention branch has no backward (`models.layers.FLASH_NO_BACKWARD`),
so a train step refuses ``use_flash_kernel=True``.
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

__all__ = ["TrainState", "init_state", "make_train_step", "make_eval_step"]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), AdamW's state and the step (a 0-d int32
    tensor on the model's device); a train step updates all three in
    place."""
    model: Transformer
    opt_state: dict
    step: torch.Tensor


def init_state(generator: torch.Generator, cfg: ModelConfig,
               opt_cfg: AdamWConfig, device=None) -> TrainState:
    """A randomly initialized model (`Transformer.init` from ``generator``,
    which must live on ``device``), zero moments and step 0 on ``device``
    (the card unless the caller names another)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device).init(generator)
    return TrainState(model=model, opt_state=adamw_init(model, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _to_device(batch, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _check_mesh(mesh, device) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    if mesh.size > 1:
        raise NotImplementedError(
            f"training over a mesh of {mesh.size} ranks is not ported yet: "
            "it needs the gradient all-reduce JAX gets from GSPMD "
            "(ROADMAP.md, A14.6)")
    return mesh.check_device(device)


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
    one-rank ``mesh`` names its own). ``batch`` maps ``"tokens"`` (and
    optionally ``"loss_mask"``) to [B, S] arrays or tensors, and holds the
    ``"frames"`` [B, T, d] of an encoder-decoder or the ``"patches"`` [B,
    P, d] of a patch config.

    ``microbatch``: split the batch into this many sequential micro-steps,
    row ``j*microbatch + m`` to micro-step ``m`` (JAX's reshape and swap);
    the gradient is the mean of theirs, accumulated in float32, the loss
    the mean of theirs, the other metrics the last micro-step's.
    ``orthogonal_update``: TSQR-orthogonalize the gradients
    (`repro_torch.optim.orthogonalized_update`, judged as JAX's stacked
    leaves). ``metrics`` is JAX's ``dict(ce, aux, zloss, tokens, loss,
    grad_norm, lr)`` of 0-d tensors on the device."""
    if cfg.use_flash_kernel:
        raise NotImplementedError(f"make_train_step: {FLASH_NO_BACKWARD}")
    dev = _check_mesh(mesh, device)

    def grads_of(model, batch):
        loss, metrics = model.loss_fn(batch, cfg)
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            grads[name], p.grad = p.grad, None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        batch = _to_device(batch, dev)
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
                    loss, metrics, g = grads_of(model, mb)
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
                loss, metrics, grads = grads_of(model, batch)
        if orthogonal_update:
            grads = orthogonalized_update(grads, model=model)
        _, _, opt_metrics = adamw_update(grads, state.opt_state, model,
                                         opt_cfg)
        del grads
        state.step.add_(1)
        return state, dict(metrics, loss=loss, **opt_metrics)

    return step_fn


def make_eval_step(cfg: ModelConfig, device=None) -> Callable:
    """``eval_fn(model, batch) -> dict(metrics, loss=loss)`` for a
    `repro_torch.models.transformer.Transformer` on ``device`` (the card
    unless ``device="cpu"``). ``batch`` maps ``"tokens"`` (and optionally
    ``"loss_mask"``) to [B, S] arrays or tensors, with ``"frames"`` or
    ``"patches"`` as `make_train_step`'s; they are moved to the device. The forward runs under ``cfg`` — with ``cfg.use_flash_kernel``
    its attention goes through the flash-attention kernel."""
    dev = resolve_device(device)

    def eval_fn(model, batch):
        batch = _to_device(batch, dev)
        with torch.inference_mode():
            loss, metrics = model.loss_fn(batch, cfg)
        return dict(metrics, loss=loss)

    return eval_fn
