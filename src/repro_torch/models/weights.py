"""Load a JAX parameter tree into the port's `Transformer`.

The tests hold the port to the JAX package on the same weights: JAX's
``init_params`` draws them, ``jax.tree_util.tree_map(np.asarray, params)``
turns them into numpy, and `params_from_jax` copies them into the port's
modules. The port's own random init (`Transformer.init`) does not reproduce
JAX's PRNG.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Transformer


def _leaf(tree, name: str):
    """The array of JAX's tree for the port's parameter ``name``: the stack
    ``blocks.<i>.<j>.<path>`` is ``tree["blocks"]["pos<j>"][<path>][i]``
    (super-blocks stacked on axis 0)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, j, rest = int(parts[1]), int(parts[2]), parts[3:]
        node = tree["blocks"][f"pos{j}"]
        for key in rest:
            node = node[key]
        return node[i]
    node = tree
    for key in parts:
        node = node[key]
    return node


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Transformer:
    """A `Transformer` for ``cfg`` on ``device`` (the card unless the caller
    names another) holding the parameters of ``tree`` — JAX's
    ``init_params`` pytree as numpy arrays."""
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = np.asarray(_leaf(tree, name))
            if arr.dtype.name == "bfloat16":  # ml_dtypes; torch reads float32
                arr = arr.astype(np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))
    return model
