"""The LM's eval step on one device.

The port of the JAX package's ``train/step.py:make_eval_step``: the loss and
metrics of a batch under a configuration, with no mesh (one card) and no
gradient. The train step (loss, gradients and the AdamW update) is still to
be ported (ROADMAP A14.2).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels._platform import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["make_eval_step"]


def make_eval_step(cfg: ModelConfig, device=None) -> Callable:
    """``eval_fn(model, batch) -> dict(metrics, loss=loss)`` for a
    `repro_torch.models.transformer.Transformer` on ``device`` (the card
    unless ``device="cpu"``). ``batch`` maps ``"tokens"`` (and optionally
    ``"loss_mask"``) to [B, S] arrays or tensors; they are moved to the
    device. The forward runs under ``cfg`` — with ``cfg.use_flash_kernel``
    its attention goes through the flash-attention kernel."""
    dev = resolve_device(device)

    def eval_fn(model, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            loss, metrics = model.loss_fn(batch, cfg)
        return dict(metrics, loss=loss)

    return eval_fn
