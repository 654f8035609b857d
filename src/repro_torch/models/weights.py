"""Carry parameters, AdamW moments and decode caches between the port's
`Transformer` and the JAX package's trees, in both directions.

The tests hold the port to the JAX package on the same weights: JAX's
``init_params`` draws them, ``jax.tree_util.tree_map(np.asarray, params)``
turns them into numpy, and `params_from_jax` copies them into the port's
modules. The port's own random init (`Transformer.init`) does not reproduce
JAX's PRNG. A cache keeps JAX's tree on both sides (``{"blocks":
{"pos<j>": {<kind>: {<leaf>: …}}}, "pos"}``, the kinds ``attn``, ``cross``,
``mamba``, ``rwkv`` and ``cmix``, leaves stacked over the super-blocks):
`cache_from_jax` turns JAX's numpy leaves into the port's tensors,
`cache_to_numpy` the port's back, so tests compare leaf by leaf.

The port holds one parameter per super-block (``blocks.<i>.<j>.<path>``,
and an encoder-decoder's ``encoder.<i>.<j>.<path>``); JAX stacks each over
its stack's super-blocks (``blocks/pos<j>/<path>`` over ``n_blocks``,
``encoder/pos<j>/<path>`` over ``encoder_blocks``, axis 0).
`params_to_numpy` gives JAX's stacked tree of a model, the inverse of
`params_from_jax`, and `opt_state_to_numpy` / `opt_state_from_jax` do the
same for AdamW's state, whose moments the port keys by parameter name. The
checkpoint manager writes these trees, so a checkpoint of either package
restores in the other. `jax_path` and `jax_ndim` name a parameter's leaf
and rank in JAX's tree: AdamW's weight decay and the orthogonal update
decide by that rank, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._platform import resolve_device
from .config import ModelConfig
from .layers import dtype_of
from .transformer import Transformer


_STACKS = ("blocks", "encoder")  # the trees JAX stacks over super-blocks


def block_index(name: str) -> int | None:
    """The super-block ``i`` of a stacked parameter ``<stack>.<i>.<j>.…``
    (``stack`` ``blocks`` or ``encoder``); None for any other name."""
    parts = name.split(".")
    return int(parts[1]) if parts[0] in _STACKS else None


def _leaf(tree, name: str):
    """The array of JAX's tree for the port's parameter ``name``: the stack
    ``<stack>.<i>.<j>.<path>`` is ``tree[<stack>]["pos<j>"][<path>][i]``
    (super-blocks stacked on axis 0)."""
    node = tree
    for key in jax_path(name):
        node = node[key]
    i = block_index(name)
    return node if i is None else node[i]


def jax_path(name: str) -> tuple[str, ...]:
    """The keys of the port's parameter ``name`` in JAX's tree:
    ``<stack>.<i>.<j>.<path>`` is the slice ``[i]`` of ``(<stack>,
    "pos<j>", *path)``, any other name its own dotted path."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        return (parts[0], f"pos{parts[2]}", *parts[3:])
    return tuple(parts)


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of JAX's leaf for the port's parameter ``name``: one more
    than the port's for a super-block's parameter (JAX stacks it)."""
    return t.ndim if block_index(name) is None else t.ndim + 1


def stack_depth(cfg: ModelConfig, name: str) -> int:
    """The super-blocks JAX stacks a stacked parameter ``name`` over:
    ``cfg.encoder_blocks`` in the encoder, else ``cfg.n_blocks``."""
    return cfg.encoder_blocks if name.startswith("encoder.") else \
        cfg.n_blocks


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own, on the host (bfloat16 widened
    to float32, which holds it exactly). Always a copy: on the CPU a
    tensor's ``.cpu()`` is the tensor itself, and parameters change in
    place."""
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.to("cpu", copy=True).numpy()


def stack_to_tree(named: dict) -> dict:
    """Tensors keyed by the port's parameter names → JAX's tree of numpy
    arrays, each super-block's parameters stacked on axis 0 in the order
    of their super-blocks."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        path, i = jax_path(name), block_index(name)
        if i is None:
            _put(tree, path, to_numpy(t))
        else:
            stacks.setdefault(path, {})[i] = to_numpy(t)
    for path, leaves in stacks.items():
        _put(tree, path, np.stack([leaves[i] for i in range(len(leaves))]))
    return tree


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_to_numpy(model: Transformer) -> dict:
    """The model's parameters as JAX's ``init_params`` tree of numpy
    arrays (super-block parameters stacked), the inverse of
    `params_from_jax`."""
    return stack_to_tree(dict(model.named_parameters()))


def opt_state_to_numpy(opt_state: dict, model: Transformer) -> dict:
    """AdamW's state (`repro_torch.optim.adamw_init`, moments keyed by
    ``model``'s parameter names) as JAX's ``{"mu", "nu", "step"}`` tree of
    numpy arrays."""
    return {"mu": stack_to_tree(opt_state["mu"]),
            "nu": stack_to_tree(opt_state["nu"]),
            "step": to_numpy(opt_state["step"]).astype(np.int32)}


def opt_state_from_jax(tree, model: Transformer,
                       state_dtype: str = "float32") -> dict:
    """JAX's AdamW state ``tree`` (``{"mu", "nu", "step"}`` as numpy
    arrays) as the port's, on ``model``'s device: the moments keyed by its
    parameter names in ``state_dtype``, the step a 0-d int32 tensor."""
    dt = dtype_of(state_dtype)
    out = {"mu": {}, "nu": {}}
    for name, p in model.named_parameters():
        for key in ("mu", "nu"):
            arr = _numpy(_leaf(tree[key], name))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key} {name}: JAX shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            out[key][name] = torch.from_numpy(arr).to(p.device, dt)
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=model.embed.device)
    return out


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
    ``decode_step``'s, as numpy arrays): the positions int32, the mamba
    and rwkv recurrent states (``ssm``, ``state``) float32, every other
    leaf in ``cfg``'s compute dtype, as JAX's ``init_cache`` makes them.
    Raises `ValueError` unless the tree has ``cfg``'s sub-layers and its
    leaves are stacked over ``cfg.n_blocks``."""
    device = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    dtypes = {"pos": torch.int32, "ssm": torch.float32,
              "state": torch.float32}
    names = {f"pos{j}" for j in range(len(cfg.block))}
    if set(tree["blocks"]) != names:
        raise ValueError(f"cache sub-layers {sorted(tree['blocks'])} != "
                         f"{sorted(names)}")
    blocks = {}
    for j, sub in tree["blocks"].items():
        blocks[j] = {}
        for kind, leaves in sub.items():
            blocks[j][kind] = {}
            for name, leaf in leaves.items():
                arr = _numpy(leaf)
                if arr.shape[0] != cfg.n_blocks:
                    raise ValueError(f"{j}.{kind}.{name}: {arr.shape[0]} "
                                     f"super-blocks != {cfg.n_blocks}")
                blocks[j][kind][name] = torch.from_numpy(arr).to(
                    device, dtypes.get(name, cdt))
    pos = torch.tensor(int(np.asarray(tree["pos"])), dtype=torch.int32,
                       device=device)
    return {"blocks": blocks, "pos": pos}


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache as JAX's tree of numpy arrays (bfloat16 leaves
    widened to float32)."""
    return {"blocks": {j: {kind: {name: to_numpy(leaf)
                                  for name, leaf in leaves.items()}
                           for kind, leaves in sub.items()}
                       for j, sub in cache["blocks"].items()},
            "pos": to_numpy(cache["pos"])}
