"""AdamW with global-norm clipping and configurable state dtype.

The port of the JAX package's ``optim/adamw.py``, updating in place: the
parameters (a `Transformer`'s, or a dict of tensors) and the moments are
written under ``torch.no_grad()``, and `adamw_update` returns the same
objects. Everything is computed in float32 as JAX computes it: the global
norm of the float32 gradients, the clip scale, bias correction with
``b ** step`` in float32; the moments are stored in ``cfg.state_dtype``.

Decoupled weight decay applies to matrices only, and "matrix" is decided by
the rank of JAX's leaf (`repro_torch.models.weights.jax_ndim`): JAX stacks
every super-block parameter over the super-blocks, so it decays the block
norm scales (``[n_blocks, d]``) and not ``final_norm`` (``[d]``). A dict of
tensors keeps the plain ``ndim >= 2`` rule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch.models.layers import dtype_of
from repro_torch.models.weights import jax_ndim

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def _named(params) -> tuple[dict, dict]:
    """``params`` as ``{name: tensor}`` (a module's named parameters, or
    the dict itself) and each one's rank as the weight decay reads it:
    JAX's stacked rank for a module's, the tensor's own for a dict's."""
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        return named, {n: jax_ndim(n, t) for n, t in named.items()}
    return dict(params), {n: t.ndim for n, t in params.items()}


def global_norm(tree: dict) -> torch.Tensor:
    """√(Σ g²) over every tensor of ``tree``, in float32."""
    total = 0
    for g in tree.values():
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{"mu", "nu"}`` zeros in ``cfg.state_dtype`` keyed by parameter
    name, and ``"step"`` a 0-d int32 zero, on the parameters' device."""
    dt = dtype_of(cfg.state_dtype)
    named, _ = _named(params)
    device = next(iter(named.values())).device
    return {
        "mu": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
               for n, p in named.items()},
        "nu": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
               for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params,
                 cfg: AdamWConfig, *, grad_norm=None) -> tuple:
    """One AdamW step. ``grads`` maps each parameter name to its gradient.
    Writes the parameters, the moments and the step in place and returns
    ``(params, opt_state, metrics)`` — the objects passed in — with
    ``metrics = {"grad_norm", "lr"}`` (0-d float32 tensors). ``grad_norm``
    is the gradients' global norm where the caller has it (a sharded step,
    whose ``grads`` are slices); by default `global_norm` of ``grads``."""
    named, ndims = _named(params)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    # Each update in place on its own temporaries, in the same order of
    # operations as the expressions of JAX's update (the same roundings):
    # at most four float32 copies of a parameter are alive at once.
    for name, p in named.items():
        g = grads[name].float() * scale
        m32 = (opt_state["mu"][name].float() * cfg.b1).add_((1 - cfg.b1) * g)
        v32 = (opt_state["nu"][name].float() * cfg.b2).add_(
            ((1 - cfg.b2) * g).mul_(g))
        del g
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        if ndims[name] >= 2:  # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))
        del delta
        opt_state["mu"][name].copy_(m32)  # rounded to the state's dtype
        opt_state["nu"][name].copy_(v32)
    opt_state["step"].copy_(step)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return params, opt_state, metrics
