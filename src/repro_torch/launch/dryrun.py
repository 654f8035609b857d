"""Dry run of the production cells: rank 0's real train step, prefill or
decode step on fake tensors over a fake world of 256 or 512 ranks.

The port of the JAX package's ``launch/dryrun.py``. JAX lowers and
compiles each (arch × shape × mesh) cell against 512 placeholder host
devices; the port initializes a ``"fake"`` process group of 256 (16 × 16)
or 512 (2 × 16 × 16) ranks in this process
(`torch.testing._internal.distributed.fake_pg.FakeStore`), builds rank
0's slice of the state (a train cell's parameters and moments; a serving
cell's parameters, and a decode cell's cache as ``cache_specs`` lays it
out) under ``FakeTensorMode`` (nothing is allocated) and runs rank 0's
real train step (`repro_torch.train.step`), prefill or decode step
(`repro_torch.train.serve`) on it. Per device, that is rank 0's local
program:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step
    (`flop_counter`: without its module tracker, whose hooks keep every
    super-block's activations alive through remat);
  * bytes accessed: the sum of each aten op's input and output bytes
    (views excluded). Unfused: every elementwise op reads and writes its
    operands, so this overstates what the card moves;
  * collective bytes: the operands of every collective the step issued
    (`repro_torch.sharding.collectives`), per kind;
  * peak memory: the state and batch slices plus the largest sum of live
    tensor bytes the step reaches (a tracker of every storage the step
    allocates, freed with it), checked against the card in
    ``chip_smoke.py`` phases 14b and 15b. A decode step writes its cache in
    place, as JAX's donation aliases it: the cache counts once, in the
    state.

A fake step's time grows with depth × micro-steps × ops, so, as JAX's cost
pass, every figure comes from steps of 1 and 2 super-blocks extrapolated
linearly in depth, C(n) = C(1) + (n − 1)·(C(2) − C(1)), exact for
homogeneous stacks: the cost pass (FLOPs, bytes, collectives) with one
micro-step and JAX's overrides ``attn_block_kv = max(seq, …)`` and
``ssm_chunk = seq``, the memory pass (the peak) on the cell's own program
(its micro-steps, blocks and chunks). ``lower_s`` is the seconds the
memory pass took to build its fake states, ``compile_s`` the seconds of
its steps, ``cost_pass_s`` the cost pass's.

A serving cell runs as JAX's: bfloat16 parameters, FSDP kept only where
the parameters split over ``model`` alone would pass 6 GB a device
(``serve_bf16``), the KV slots over ``model`` (``kv_seq_shard``), a decode
step attending in one block (``attn_block_kv = max(seq, …)``), and
long_500k's batch of one served with ``shard_seq`` (its slots over
``data``). Model FLOPs are 2·N_active·B·S for a prefill and 2·N_active·B
for a decode step.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out benchmarks/results/dryrun_torch

``--host-mesh D,M`` runs a (D, M) ``("data", "model")`` mesh of D·M fake
ranks instead of a production mesh, and ``--blocks``, ``--batch``,
``--seq`` and ``--micro`` cut a cell, so that a dry run can be held to a
real step of the same cut.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.roofline import build_roofline, collective_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.sharding.rules import data_axes, mesh_shape

__all__ = ["OPT_DEFAULTS", "cell_config", "flop_counter", "input_specs",
           "run_cell", "main"]

#: Post-hillclimb defaults of the JAX package (its EXPERIMENTS.md §Perf),
#: with JAX's keys. Four of them change the port's cells; two are hints
#: JAX's sharding constraints read and the port has no counterpart of.
OPT_DEFAULTS = {
    "hier_moe": True,       # moe_groups = the data ranks (else 1)
    # No effect: JAX's hint to keep activations split over the sequence
    # between layers; the port's activations between layers are whole over
    # ``model`` (each layer's output summed or gathered over it).
    "seq_parallel": True,
    # No effect: the port's head is always vocab-split over ``model`` and
    # its loss vocab-parallel; only the eval forward gathers the logits.
    "sharded_logits": True,
    # Serving: bfloat16 parameters, FSDP dropped where the parameters split
    # over ``model`` fit in 6 GB a device.
    "serve_bf16": True,
    "kv_seq_shard": True,   # KV slots over ``model`` (else the head dim)
    "train_bf16": False,    # bfloat16 parameters and moments
}


class _Global:
    """A module tracker that attributes every op to ``"Global"``."""

    parents = frozenset({"Global"})

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


def flop_counter():
    """A ``FlopCounterMode`` (no display) that counts as it counts, by its
    registry, with its module tracker left out: the tracker's hooks hold
    each super-block's activations until the step ends, which undoes remat
    (≈ 15 GB a qwen3-8b block at 2 × 4,096 tokens). ``get_total_flops()``
    is the count."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _Global()
    return counter


def _fake_world(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks in this process, this
    process rank 0 (an existing fake group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if str(dist.get_backend()) == "fake" and \
                dist.get_world_size() == world:
            return
        if str(dist.get_backend()) != "fake":
            raise RuntimeError("the dry run needs a process of its own: "
                               "this one is in a real process group")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(dims: tuple[int, ...]):
    """The fake world's mesh: production (16, 16) or (2, 16, 16), or a
    host (D, M) mesh."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    _fake_world(math.prod(dims))
    if tuple(dims) in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(dims) == 3, device="cpu")
    return make_host_mesh(model=dims[1], device="cpu")


def _shape_spec(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def cell_config(cfg: ModelConfig, shape, mesh,
                opts: dict | None = None) -> ModelConfig:
    """``cfg`` as a cell of ``shape`` on ``mesh`` (a mesh or an axis →
    size dict) runs it under ``opts`` (over `OPT_DEFAULTS`): with
    ``hier_moe`` a MoE routes in one group per data rank, else in one
    global group; a train cell under ``train_bf16`` stores the parameters
    and moments in bfloat16; a serving cell under ``serve_bf16`` stores
    the parameters in bfloat16 and keeps FSDP only where 2·N / |model|
    passes 6 GB; a decode step attends in one block of the whole cache.
    ``kv_seq_shard`` is the cache's layout (`input_specs`)."""
    opts = dict(OPT_DEFAULTS, **(opts or {}))
    spec = _shape_spec(shape)
    shape_of = mesh_shape(mesh)
    if spec.global_batch > 1:
        dp_size = math.prod(shape_of[a] for a in data_axes(shape_of))
        cfg = dataclasses.replace(
            cfg, moe_groups=dp_size if (cfg.moe and opts["hier_moe"]) else 1)
    if spec.kind == "train" and opts["train_bf16"]:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                  opt_state_dtype="bfloat16")
    if spec.kind != "train" and opts["serve_bf16"]:
        resident_gb = 2 * cfg.param_count() / shape_of.get("model", 1) / 1e9
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                  fsdp=cfg.fsdp and resident_gb > 6.0)
    if spec.kind == "decode":
        cfg = dataclasses.replace(
            cfg, attn_block_kv=max(spec.seq_len, cfg.attn_block_kv))
    return cfg


class _Cell:
    """A cell's program on rank 0: ``fn(*args)``, the tensors that exist
    before it (``held``: the state, the parameters, a decode step's cache)
    and the bytes of rank 0's rows of the batch."""

    def __init__(self, fn, args, flops, held, rows_bytes, aliased=0):
        self.fn, self.args, self.flops = fn, args, flops
        self.held, self.rows_bytes, self.aliased = held, rows_bytes, aliased


def _inputs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    cdt = dtype_of(cfg.compute_dtype)
    text = seq - cfg.patch_positions if cfg.patch_positions else seq
    inputs = {"tokens": torch.zeros((batch, text), dtype=torch.int32)}
    if cfg.is_enc_dec:
        inputs["frames"] = torch.zeros((batch, cfg.encoder_len, cfg.d_model),
                                       dtype=cdt)
    if cfg.patch_positions:
        inputs["patches"] = torch.zeros(
            (batch, cfg.patch_positions, cfg.d_model), dtype=cdt)
    return inputs


def _cell(cfg: ModelConfig, shape, mesh, *, force_micro: int | None = None,
          opts: dict | None = None) -> _Cell:
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import TrainState, make_train_step, \
        shard_state

    spec = _shape_spec(shape)
    opts = dict(OPT_DEFAULTS, **(opts or {}))
    batch, seq = spec.global_batch, spec.seq_len
    dp_size = math.prod(mesh.shape[a] for a in data_axes(mesh))
    cfg = cell_config(cfg, spec, mesh, opts)
    n_active = cfg.active_param_count()
    if spec.kind != "train":
        return _serve_cell(cfg, spec, mesh, opts, n_active)
    opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    micro = max(1, batch // dp_size) if seq >= 4096 else 1
    if force_micro is not None:
        micro = force_micro

    model = Transformer(cfg, device="cpu")
    state = TrainState(model=model, opt_state=adamw_init(model, opt_cfg),
                       step=torch.zeros((), dtype=torch.int32))
    shard_state(state, mesh)
    inputs = _inputs(cfg, batch, seq)
    step = make_train_step(cfg, opt_cfg, mesh, microbatch=micro,
                           device="cpu")
    held = [*model.parameters(), state.step, state.opt_state["step"],
            *(t for k in ("mu", "nu") for t in state.opt_state[k].values())]
    rows = sum(_nbytes(v) // state.placement.data.size
               for v in inputs.values())
    return _Cell(step, (state, inputs), 6.0 * n_active * batch * seq, held,
                 rows)


def _serve_cell(cfg: ModelConfig, spec, mesh, opts: dict,
                n_active: int) -> _Cell:
    """A prefill or decode cell: rank 0's parameters, the global batch (a
    prefill) or rank 0's cache slice and token rows (a decode step)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.cache import CacheLayout, ServeCache
    from repro_torch.train.serve import (make_decode_step, make_prefill,
                                         shard_model)

    batch, seq = spec.global_batch, spec.seq_len
    shard_seq = batch == 1  # context parallelism for long_500k
    kv_seq = bool(opts["kv_seq_shard"])
    model = shard_model(Transformer(cfg, device="cpu"), mesh)
    params = list(model.parameters())
    if spec.kind == "prefill":
        inputs = _inputs(cfg, batch, seq)
        fn = make_prefill(cfg, seq, "cpu", mesh=mesh, shard_seq=shard_seq,
                          kv_seq_over_model=kv_seq)
        rows = CacheLayout.rows_of(mesh, shard_seq)
        return _Cell(fn, (model, inputs), 2.0 * n_active * batch * seq,
                     params, sum(_nbytes(v) // rows for v in inputs.values()))
    layout = CacheLayout(cfg, mesh, model.cache_shapes(batch, seq, cfg),
                         shard_seq=shard_seq, kv_seq_over_model=kv_seq)
    blocks = model.init_cache(batch, seq, cfg, layout=layout)
    cache = ServeCache({"blocks": blocks, "pos": torch.zeros(
        (), dtype=torch.int32)}, layout)
    tokens = torch.zeros((batch // layout.rows, 1), dtype=torch.int32)
    leaves = [t for kinds in blocks.values() for leaves in kinds.values()
              for t in leaves.values()] + [cache["pos"]]
    fn = make_decode_step(cfg, "cpu", mesh=mesh)
    return _Cell(fn, (model, cache, tokens), 2.0 * n_active * batch,
                 params + leaves, _nbytes(tokens),
                 aliased=sum(_nbytes(t) for t in leaves))


def input_specs(cfg: ModelConfig, shape, mesh, *,
                force_micro: int | None = None, opts: dict | None = None):
    """(fn, args, model_flops) of a cell: a train cell's step and (rank 0's
    sharded state, the global batch); a prefill cell's ``prefill_fn`` and
    (rank 0's sharded model, the global batch); a decode cell's
    ``decode_fn`` and (the model, rank 0's cache slice, its token rows),
    built as fake tensors. Call it inside the ``FakeTensorMode`` the
    program will run in."""
    cell = _cell(cfg, shape, mesh, force_micro=force_micro, opts=opts)
    return cell.fn, cell.args, cell.flops


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Accounting:
    """A dispatch mode that sums each op's input and output bytes (views
    excluded) and tracks the bytes of the storages the ops allocate while
    they live (``live``, ``peak``)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        owner = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                owner._see(func, args, kwargs, out)
                return out

        self.mode = Mode()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}

    def _see(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_leaves

        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not getattr(func, "is_view", False):
            ins = [t for t in tree_leaves((args, kwargs or {}))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._sizes:
                continue
            n = storage.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def exclude(self, tensors) -> None:
        """Count nothing for the storages of ``tensors`` (the state and the
        inputs, which exist before the step): a view of them or an op that
        writes into them allocates nothing."""
        for t in tensors:
            self._sizes[t.untyped_storage()._cdata] = 0


def _pass(cfg: ModelConfig, shape, mesh, *, force_micro, opts,
          count: bool) -> dict:
    """One fake step of ``cfg``: its FLOPs, bytes, collectives (``count``)
    or its peak memory, with the seconds it took to build and to run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding.collectives import recording

    t0 = time.perf_counter()
    with FakeTensorMode():
        cell = _cell(cfg, shape, mesh, force_micro=force_micro, opts=opts)
        state_b = sum(_nbytes(t) for t in cell.held
                      if t.dtype != torch.int32 or t.ndim)
        rows_b, aliased = cell.rows_bytes, cell.aliased
        t_build = time.perf_counter() - t0
        acc = _Accounting()
        acc.exclude([*cell.held, *(t for a in cell.args
                                   if isinstance(a, dict)
                                   for t in a.values()
                                   if isinstance(t, torch.Tensor)),
                     *(a for a in cell.args if isinstance(a, torch.Tensor))])
        with recording() as record, flop_counter() as fc, acc.mode:
            cell.fn(*cell.args)
        del cell
    out = {"build_s": t_build, "run_s": time.perf_counter() - t0 - t_build,
           "state": state_b, "rows": rows_b, "aliased": aliased}
    if count:
        out.update({"flops": float(fc.get_total_flops()),
                    "bytes accessed": float(acc.bytes),
                    "coll": collective_bytes(record)})
    else:
        out["peak"] = float(state_b + rows_b + acc.peak)
    return out


def _depths(cfg: ModelConfig, k: int, **over) -> ModelConfig:
    return dataclasses.replace(
        cfg, n_blocks=k, encoder_blocks=k if cfg.is_enc_dec else 0,
        scan_layers=False, **over)


def _extrap(a: dict, b: dict, n: int) -> dict:
    return {k: max(0.0, float(a.get(k, 0.0))
                   + (n - 1) * (float(b.get(k, 0.0)) - float(a.get(k, 0.0))))
            for k in set(a) | set(b)
            if isinstance(a.get(k, b.get(k)), (int, float))}


def _check_depth(cfg: ModelConfig) -> None:
    if cfg.encoder_blocks not in (0, cfg.n_blocks):
        raise ValueError("depth extrapolation assumes encoder_blocks == "
                         "n_blocks")


def _cost_pass(cfg: ModelConfig, shape, mesh, *,
               overrides: dict | None = None, opts: dict | None = None):
    """FLOPs, bytes and collective bytes of the full-depth step, from fake
    steps of 1 and 2 super-blocks with one micro-step, extrapolated in
    depth; returns (cost, coll, seconds)."""
    _check_depth(cfg)
    seq = _shape_spec(shape).seq_len
    ov = dict(overrides or {})
    over = {"attn_block_kv": ov.pop("attn_block_kv",
                                    max(seq, cfg.attn_block_kv)),
            "ssm_chunk": ov.pop("ssm_chunk", seq), **ov}
    t0 = time.perf_counter()
    c1, c2 = (_pass(_depths(cfg, k, **over), shape, mesh, force_micro=1,
                    opts=opts, count=True) for k in (1, 2))
    n = cfg.n_blocks
    cost = _extrap(c1, c2, n)
    coll = {k: int(v) for k, v in _extrap(c1["coll"], c2["coll"], n).items()}
    return ({k: cost[k] for k in ("flops", "bytes accessed")}, coll,
            time.perf_counter() - t0)


def _memory_pass(cfg: ModelConfig, shape, mesh, *, force_micro, opts):
    """The cell's own program at 1 and 2 super-blocks, extrapolated: its
    peak, state and rows' bytes, and the seconds it took to build the
    states and to run the steps. Of a cell of more than two micro-steps it
    runs two, on the same rows per micro-step: from the second on a
    micro-step's peak repeats (the same shapes, the same accumulators)."""
    _check_depth(cfg)
    spec = _shape_spec(shape)
    dp = math.prod(mesh.shape[a] for a in data_axes(mesh))
    micro = max(1, spec.global_batch // dp) if spec.seq_len >= 4096 else 1
    micro = force_micro if force_micro is not None else micro
    run = spec
    if spec.kind == "train" and micro > 2 and \
            spec.global_batch % (dp * micro) == 0:
        per_micro = spec.global_batch // (dp * micro)
        run = ShapeSpec(spec.name, spec.seq_len, dp * per_micro * 2,
                        spec.kind)
        micro = 2
    m1, m2 = (_pass(_depths(cfg, k), run, mesh, force_micro=micro,
                    opts=opts, count=False) for k in (1, 2))
    if run is not spec:  # the argument bytes of the cell's own rows
        scale = spec.global_batch / run.global_batch
        for m in (m1, m2):
            m["peak"] += m["rows"] * (scale - 1)
            m["rows"] *= scale
    out = _extrap(m1, m2, cfg.n_blocks)
    out["build_s"] = m1["build_s"] + m2["build_s"]
    out["run_s"] = m1["run_s"] + m2["run_s"]
    return out


def _model_flops(cfg: ModelConfig, spec) -> float:
    """JAX's model FLOPs of a cell: 6·N_active·B·S a train step,
    2·N_active·B·S a prefill, 2·N_active·B a decode step (N_active of the
    config as given, as JAX's)."""
    n = cfg.active_param_count() * spec.global_batch
    if spec.kind == "train":
        return 6.0 * n * spec.seq_len
    return 2.0 * n * (spec.seq_len if spec.kind == "prefill" else 1)


def run_cell(arch: str, shape_name, multi_pod: bool, out_dir: str, *,
             smoke: bool = False, verbose: bool = True,
             with_cost: bool | None = None, opts: dict | None = None,
             cost_overrides: dict | None = None,
             host_mesh: tuple[int, int] | None = None,
             blocks: int | None = None,
             force_micro: int | None = None) -> dict:
    """One cell's record (JAX's keys), written to ``out_dir`` as
    ``<arch>__<shape>__<mesh>.json``. ``shape_name`` is a name of `SHAPES`
    or a `ShapeSpec` (a cut cell); ``host_mesh`` (D, M) replaces the
    production mesh, ``blocks`` cuts the depth."""
    spec = _shape_spec(shape_name)
    if host_mesh is not None:
        dims = tuple(host_mesh)
        mesh_name = f"{dims[0]}x{dims[1]}"
    else:
        dims = (2, 16, 16) if multi_pod else (16, 16)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = math.prod(dims)
    cfg = get_config(arch, smoke=smoke)
    if blocks is not None:
        cfg = dataclasses.replace(
            cfg, n_blocks=blocks,
            encoder_blocks=blocks if cfg.is_enc_dec else 0)
    runnable, why = cell_is_runnable(cfg, spec)
    rec = {"arch": arch, "shape": spec.name, "mesh": mesh_name,
           "status": "skipped", "reason": why}
    if not runnable:
        if verbose:
            print(f"[skip] {arch} × {spec.name} × {mesh_name}: {why}")
        return rec
    if with_cost is None:
        # Roofline table is single-pod; multi-pod proves the `pod` axis
        # shards.
        with_cost = not multi_pod or host_mesh is not None
    try:
        mesh = _mesh(dims)
        if spec.kind != "train":
            # A serving cell's dtype and FSDP are decided on the whole
            # depth, before the passes cut it.
            cfg = cell_config(cfg, spec, mesh, opts)
            opts = dict(opts or {}, serve_bf16=False)
        mem = _memory_pass(cfg, spec, mesh, force_micro=force_micro,
                           opts=opts)
        t_lower, t_compile = mem["build_s"], mem["run_s"]
        cost, coll, t_cost = ({}, {}, 0.0)
        if with_cost:
            cost, coll, t_cost = _cost_pass(cfg, spec, mesh, opts=opts,
                                            overrides=cost_overrides)
        peak = mem["peak"]
        arg = mem["state"] + mem["rows"]
        # What the program writes in place: a train step's state, a decode
        # step's cache (JAX's donated arguments); a prefill writes new ones.
        alias = mem["state"] if spec.kind == "train" else mem["aliased"]
        mem_rec = {"argument_size_in_bytes": int(arg),
                   "output_size_in_bytes": int(alias),
                   "temp_size_in_bytes": int(peak - arg),
                   "alias_size_in_bytes": int(alias),
                   "generated_code_size_in_bytes": 0}
        rec = {"status": "ok", "arch": arch, "shape": spec.name,
               "mesh": mesh_name, "memory_analysis": mem_rec,
               "peak_memory_per_device": peak,
               "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
               "cost_pass_s": round(t_cost, 1)}
        model_flops = _model_flops(cfg, spec)
        rec["model_flops"] = model_flops
        if with_cost:
            rl = build_roofline(arch=arch, shape=spec.name,
                                mesh_name=mesh_name, chips=chips, cost=cost,
                                coll=coll, peak_memory=peak,
                                model_flops=model_flops)
            rec.update(rl.to_json())
        if verbose:
            if with_cost:
                print(f"[ok]   {arch} × {spec.name} × {mesh_name}: "
                      f"mem/dev={peak / 1e9:.2f}GB "
                      f"flops/dev={rl.flops_per_device:.3e} "
                      f"coll/dev={rl.coll_bytes_per_device:.3e}B "
                      f"dominant={rl.dominant} "
                      f"(build {t_lower:.0f}s steps {t_compile:.0f}s "
                      f"cost {t_cost:.0f}s)")
            else:
                print(f"[ok]   {arch} × {spec.name} × {mesh_name}: "
                      f"mem/dev={peak / 1e9:.2f}GB memory-only "
                      f"(build {t_lower:.0f}s steps {t_compile:.0f}s)")
            print(f"       memory_analysis: {mem_rec}")
    except Exception as e:  # noqa: BLE001 — record and continue in --all
        rec = {"arch": arch, "shape": spec.name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        if verbose:
            print(f"[FAIL] {arch} × {spec.name} × {mesh_name}: {e}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn_out = os.path.join(out_dir,
                              f"{arch}__{spec.name}__{mesh_name}.json")
        with open(fn_out, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="every arch × shape (JAX's skip rule applies)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sanity, not the deliverable)")
    ap.add_argument("--baseline", action="store_true",
                    help="JAX's pre-hillclimb options: one global MoE group "
                         "(moe_groups=1); serving cells in the config's "
                         "parameter dtype with its FSDP, the KV cache's head "
                         "dim over model (no kv_seq_shard)")
    ap.add_argument("--attn-accounting", choices=["dense", "blockwise"],
                    default="dense",
                    help="cost-pass attention: 'dense' one KV block of the "
                         "whole sequence (attn_block_kv=seq); 'blockwise' "
                         "1,024-key blocks (attn_block_kv=1024)")
    ap.add_argument("--host-mesh", default=None,
                    help="D,M: a (data, model) mesh of D·M fake ranks in "
                         "place of the production mesh")
    ap.add_argument("--blocks", type=int, default=None,
                    help="cut the depth to this many super-blocks")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the global batch")
    ap.add_argument("--seq", type=int, default=None, help="cut the sequence")
    ap.add_argument("--micro", type=int, default=None,
                    help="micro-steps (default: one row per data rank at "
                         "seq >= 4096, as JAX's)")
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch")
    args = ap.parse_args(argv)
    opts = ({k: False for k in OPT_DEFAULTS} if args.baseline else None)
    cost_overrides = None
    if args.attn_accounting == "blockwise":
        cost_overrides = {"attn_block_kv": 1024}
    host = None
    if args.host_mesh:
        host = tuple(int(x) for x in args.host_mesh.split(","))

    archs = ARCH_NAMES if args.all or not args.arch else args.arch
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if host is not None:
        meshes = [False]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            spec = SHAPES[shape]
            if args.batch or args.seq:
                spec = ShapeSpec(spec.name, args.seq or spec.seq_len,
                                 args.batch or spec.global_batch, spec.kind)
            for mp in meshes:
                rec = run_cell(arch, spec, mp, args.out, smoke=args.smoke,
                               opts=opts, cost_overrides=cost_overrides,
                               host_mesh=host, blocks=args.blocks,
                               force_micro=args.micro)
                n_fail += rec["status"] == "error"
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
