"""Load a JAX parameter tree into the port's `Transformer`, and carry a
decode cache across in both directions.

The tests hold the port to the JAX package on the same weights: JAX's
``init_params`` draws them, ``jax.tree_util.tree_map(np.asarray, params)``
turns them into numpy, and `params_from_jax` copies them into the port's
modules. The port's own random init (`Transformer.init`) does not reproduce
JAX's PRNG. A cache keeps JAX's tree on both sides (``{"blocks":
{"pos<j>": {"attn": {"k", "v", "pos"}}}, "pos"}``, leaves stacked over the
super-blocks): `cache_from_jax` turns JAX's numpy leaves into the port's
tensors, `cache_to_numpy` the port's back, so tests compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._platform import resolve_device
from .config import ModelConfig
from .layers import dtype_of
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


def _numpy(arr) -> np.ndarray:
    """A JAX leaf as numpy that torch reads: bfloat16 (ml_dtypes) widened
    to float32, which holds it exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return np.array(arr)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Transformer:
    """A `Transformer` for ``cfg`` on ``device`` (the card unless the caller
    names another) holding the parameters of ``tree`` — JAX's
    ``init_params`` pytree as numpy arrays."""
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = _numpy(_leaf(tree, name))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model


def cache_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """The port's decode cache on ``device`` (the card unless the caller
    names another) holding JAX's cache ``tree`` (``prefill``'s or
    ``decode_step``'s, as numpy arrays): ``k``/``v`` in ``cfg``'s compute
    dtype, the positions int32. Raises `ValueError` unless the tree has
    ``cfg``'s sub-layers and its leaves are stacked over ``cfg.n_blocks``."""
    device = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    names = {f"pos{j}" for j in range(len(cfg.block))}
    if set(tree["blocks"]) != names:
        raise ValueError(f"cache sub-layers {sorted(tree['blocks'])} != "
                         f"{sorted(names)}")
    blocks = {}
    for j, sub in tree["blocks"].items():
        attn = {}
        for name, leaf in sub["attn"].items():
            arr = _numpy(leaf)
            if arr.shape[0] != cfg.n_blocks:
                raise ValueError(f"{j}.attn.{name}: {arr.shape[0]} "
                                 f"super-blocks != {cfg.n_blocks}")
            attn[name] = torch.from_numpy(arr).to(
                device, torch.int32 if name == "pos" else cdt)
        blocks[j] = {"attn": attn}
    pos = torch.tensor(int(np.asarray(tree["pos"])), dtype=torch.int32,
                       device=device)
    return {"blocks": blocks, "pos": pos}


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache as JAX's tree of numpy arrays (bfloat16 leaves
    widened to float32)."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {"blocks": {j: {"attn": {name: arr(leaf)
                                    for name, leaf in sub["attn"].items()}}
                       for j, sub in cache["blocks"].items()},
            "pos": arr(cache["pos"])}
