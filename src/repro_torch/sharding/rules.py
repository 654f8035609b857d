"""Parameter and input partition specs per architecture family.

The port of the JAX package's ``sharding/rules.py``. Axis roles
(`repro_torch.launch.mesh`):

  pod    — outermost data parallelism (multi-pod)
  data   — data parallelism; also FSDP weight sharding when ``cfg.fsdp``
  model  — tensor parallelism (attention heads, ff, vocab) and expert
           parallelism (when num_experts % |model| == 0)

KV-head caveat: the assigned archs have kv=8 < |model|=16, so KV
projections are replicated over `model` while Q heads shard.

A mesh here is anything with a ``shape`` mapping of axis name → size (a
`repro_torch.launch.mesh.AxisMesh`, or a plain dict for an abstract mesh):
the rules read nothing else. `param_specs` is keyed by the port's parameter
names; a super-block's parameter (``blocks.<i>.<j>.…``, ``encoder.<i>.<j>.…``)
gets the spec JAX gives its stacked leaf (`models.weights.jax_path`) with
the leading stacked ``None`` dropped. `param_shardings` turns the specs
into the slice of each full tensor that a rank at given mesh coordinates
holds: a dim over axes ``(a, b)`` splits into |a|·|b| chunks of
⌈dim / (|a|·|b|)⌉ (the last ones short or empty), chunk ``i_a·|b| + i_b``
at coordinates ``(i_a, i_b)`` — ``("model", "data")`` is model-major, as
in JAX.
"""

from __future__ import annotations

import re
from typing import Mapping

from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import block_index, jax_path

__all__ = ["PartitionSpec", "P", "data_axes", "param_specs",
           "param_shardings", "batch_specs", "mesh_shape", "spec_axes",
           "shard_bounds"]


class PartitionSpec(tuple):
    """A partition spec: one entry per dim, each ``None`` (replicated), an
    axis name, or a tuple of axis names (major first). Compares as the
    tuple of its entries, as JAX's does, and, as JAX's, holds a tuple of
    one name as that name and an empty tuple as ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None)
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Mapping[str, int]:
    """Axis name → size of ``mesh`` (a mesh with a ``shape``, or a dict)."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def data_axes(mesh) -> tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _join(*axes):
    """Combine axis names into one PartitionSpec entry (drop Nones)."""
    axes = tuple(a for a in axes if a is not None)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _rules(cfg: ModelConfig, shape: Mapping[str, int]) -> list:
    fs = "data" if cfg.fsdp and "data" in shape else None
    msz = shape.get("model", 1)
    kv_ok = cfg.n_kv_heads % msz == 0
    ep = cfg.moe is not None and cfg.moe.num_experts % msz == 0
    hd_heads = cfg.n_heads % msz == 0
    rw_heads = (cfg.d_model // (cfg.rwkv.head_size if cfg.rwkv else 64)) \
        % msz == 0
    # Column-parallel attention (heads over `model`) when head counts
    # divide the axis; otherwise the row-parallel fallback (d_model over
    # model(+data)) — arctic/llava (56H), minicpm (36H), whisper (6H) on a
    # 16-way axis.
    if hd_heads:
        wq = P(fs, "model", None)
        wo = P("model", None, fs)
    else:
        wq = P(_join("model", fs), None, None)
        wo = P(None, None, _join("model", fs))
    wkv = P(fs, "model", None) if kv_ok else \
        (P(fs, None, None) if hd_heads else P(_join("model", fs), None, None))
    return [
        (r"embed$", P("model", fs)),
        (r"lm_head$", P(fs, "model")),
        (r"patch_proj$", P(fs, "model")),
        (r"enc_pos$", P()),
        # attention
        (r"(mixer|cross)/wq$", wq),
        (r"(mixer|cross)/wk$", wkv),
        (r"(mixer|cross)/wv$", wkv),
        (r"(mixer|cross)/wo$", wo),
        (r"(q_norm|k_norm)$", P()),
        # dense mlp
        (r"mlp/w_gate$", P(fs, "model")),
        (r"mlp/w_up$", P(fs, "model")),
        (r"mlp/w_down$", P("model", fs)),
        # moe
        (r"moe/router$", P(fs, None)),
        (r"moe/w_gate$", P("model", fs, None) if ep else P(None, fs, "model")),
        (r"moe/w_up$", P("model", fs, None) if ep else P(None, fs, "model")),
        (r"moe/w_down$", P("model", None, fs) if ep else P(None, "model", fs)),
        # mamba
        (r"mixer/in_proj$", P(fs, "model")),
        (r"mixer/conv_w$", P(None, "model")),
        (r"mixer/conv_b$", P("model")),
        (r"mixer/x_proj$", P("model", None)),
        (r"mixer/dt_proj$", P(None, "model")),
        (r"mixer/dt_bias$", P("model")),
        (r"mixer/a_log$", P("model", None)),
        (r"mixer/d_skip$", P("model")),
        (r"mixer/out_proj$", P("model", fs)),
        # rwkv6 time-mix
        (r"mixer/w[rkvg]$", P(fs, "model")),
        (r"mixer/wo$", P("model", fs)),
        (r"mixer/bonus$", P("model" if rw_heads else None, None)),
        (r"mixer/(mu|mix_w1|mix_w2|w0|decay_w1|decay_w2|ln_x)$", P()),
        # rwkv channel-mix (under mlp/)
        (r"mlp/wk$", P(fs, "model")),
        (r"mlp/wv$", P("model", fs)),
        (r"mlp/wr$", P(fs, "model")),
        (r"mlp/(mu_k|mu_r)$", P()),
        # norms & leftovers
        (r"(norm1|norm2|norm_x|final_norm|enc_norm)/", P()),
        (r".*", P()),
    ]


def _shapes(model) -> dict[str, tuple[int, ...]]:
    """Parameter name → shape of a `Transformer` (fake tensors will do) or
    of a dict of tensors or shapes."""
    if isinstance(model, Mapping):
        return {n: tuple(getattr(s, "shape", s)) for n, s in model.items()}
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _spec_for(rules, path: str, shape: tuple[int, ...], stacked: bool,
              mshape: Mapping[str, int]) -> PartitionSpec:
    """JAX's ``spec_for`` on the leaf at ``path`` of ``shape`` (its stacked
    shape when ``stacked``)."""
    for pat, spec in rules:
        if re.search(pat, path):
            parts = list(spec)
            if stacked:
                parts = [None] + parts
            ndim = len(shape)
            parts = parts[:ndim] + [None] * (ndim - len(parts))
            # Drop axis shardings that do not divide the dim at all
            # (uneven is fine — zero-size shards are not).
            fixed = []
            for dim, ax in zip(shape, parts):
                if ax is None:
                    fixed.append(None)
                    continue
                axsz = max(mshape[a] for a in spec_axes(ax))
                fixed.append(ax if dim >= axsz else None)
            return P(*fixed)
    return P()


def param_specs(cfg: ModelConfig, mesh, model) -> dict[str, PartitionSpec]:
    """The spec of every parameter of ``model`` (a `Transformer`, or a dict
    name → shape or tensor), keyed by the port's names: JAX's spec of its
    leaf, a stacked leaf's leading ``None`` dropped."""
    mshape = mesh_shape(mesh)
    rules = _rules(cfg, mshape)
    out = {}
    for name, shape in _shapes(model).items():
        stacked = block_index(name) is not None
        leaf = ((1,) + shape) if stacked else shape  # the stacked dim is None
        spec = _spec_for(rules, "/".join(jax_path(name)), leaf, stacked,
                         mshape)
        out[name] = P(*spec[1:]) if stacked else spec
    return out


def shard_bounds(dim: int, entry, shape: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple[int, int, int]:
    """``(start, stop, chunk)`` of the slice of a dim of size ``dim`` split
    over ``entry``'s axes that the rank at ``coords`` holds; ``chunk`` is
    ⌈dim / Π|axes|⌉ (the padded size every rank's slice gathers at)."""
    axes = spec_axes(entry)
    n, index = 1, 0
    for a in axes:
        index = index * shape[a] + coords[a]
        n *= shape[a]
    chunk = -(-dim // n)
    start = min(dim, index * chunk)
    return start, min(dim, start + chunk), chunk


def param_shardings(cfg: ModelConfig, mesh, model,
                    coords: Mapping[str, int]) -> dict[str, tuple[slice, ...]]:
    """Per parameter, the slice of its full tensor that the rank at mesh
    coordinates ``coords`` (axis name → index) holds."""
    mshape = mesh_shape(mesh)
    shapes = _shapes(model)
    out = {}
    for name, spec in param_specs(cfg, mesh, model).items():
        out[name] = tuple(
            slice(*shard_bounds(dim, entry, mshape, coords)[:2])
            for dim, entry in zip(shapes[name], spec))
    return out


def batch_specs(cfg: ModelConfig, mesh, *,
                shard_seq: bool = False) -> dict[str, PartitionSpec]:
    """Input shardings: batch over (pod, data); optionally seq over data
    (context-parallel long-context decode with global_batch=1)."""
    dp = data_axes(mesh)
    if shard_seq:
        return {"tokens": P(None, None)}
    return {
        "tokens": P(dp, None),
        "frames": P(dp, None, None),
        "patches": P(dp, None, None),
        "loss_mask": P(dp, None),
    }

