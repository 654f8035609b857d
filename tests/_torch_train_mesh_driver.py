"""One gloo rank of the port's multi-rank training tests (no JAX here).

Run one process per rank::

    PYTHONPATH=src python tests/_torch_train_mesh_driver.py \\
        RANK WORLD MODEL STORE IN OUT CKPT

``tests/test_torch_train_mesh.py`` spawns WORLD of them. Each joins a gloo
group through the `FileStore` at STORE (60 s group timeout), makes the
``("data", "model")`` mesh of shape (WORLD / MODEL, MODEL) and, for every
case of `CASES` and each of its two steps, loads the state IN holds (the
JAX package's state before that step: its parameters, moments and step,
keys ``<case>/<s>/params/…``, ``…/opt/mu/…``, ``…/opt/nu/…``,
``…/opt/step``, ``…/step``) and the global batch (``<case>/<s>/batch/…``),
shards the state over the mesh, runs the port's train step and gathers the
result: rank 0 writes each step's full parameters, moments and metrics to
OUT (``.npz``, the same keys). With a CKPT directory, the first case's
first step is also checkpointed there (every rank calls ``save``; rank 0
writes) and restored into a zeroed sharded state, which must gather to the
saved one bit for bit. Where MODEL > 1 the world also runs, for every case
of `EVALS`, ``make_eval_step(mesh=, logits=True)`` on the parameters and
batch IN holds (``eval/<case>/params/…``, ``eval/<case>/batch/…``) under a
collectives record: rank 0 writes the global logits and metrics
(``eval/<case>/logits``, ``…/metrics/…``) and the labels of the forward's
all-gathers over ``model`` (``eval/<case>/gathered``). Every rank ends with
the world's group destroyed.

``… RANK WORLD MODEL STORE flops OUT`` instead runs one train step of
`FLOPS_CUT` (the dry-run test's cut) on a state every rank draws from one
seed, under ``repro_torch.launch.dryrun.flop_counter``: rank 0 writes its
count (``flops``) to OUT.
"""

import dataclasses
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

#: name → the smoke config's arch, its overrides (float32 compute
#: throughout), the MoE overrides, the global batch's rows and length,
#: micro-steps, the orthogonal update, an uneven loss mask.
CASES = {
    "qwen_mask_orth": dict(arch="qwen3-8b", over={"fsdp": True}, rows=4,
                           seq=32, mask=True, orth=True),
    # One head: on a model axis of 2 the row-parallel fallback splits
    # d_model over ("model", "data").
    "qwen_micro": dict(arch="qwen3-8b", over={"fsdp": True, "n_heads": 1,
                                              "n_kv_heads": 1},
                       rows=8, seq=16, micro=2),
    "mixtral_drop": dict(arch="mixtral-8x22b",
                         over={"fsdp": True, "moe_groups": 1},
                         moe={"capacity_factor": 0.25}, rows=4, seq=16),
    "mixtral_g2": dict(arch="mixtral-8x22b", over={"moe_groups": 2}, rows=4,
                       seq=16),
    "rwkv": dict(arch="rwkv6-1.6b", over={"fsdp": True}, rows=4, seq=16),
    "whisper": dict(arch="whisper-tiny", over={"fsdp": True}, rows=4,
                    seq=16),
    # E = 3 does not divide a model axis of 2: the experts' ff dim splits.
    "mixtral_e3": dict(arch="mixtral-8x22b", over={"fsdp": True},
                       moe={"num_experts": 3}, rows=4, seq=16),
    "jamba": dict(arch="jamba-v0.1-52b", over={"fsdp": True}, rows=4,
                  seq=16),
    "minicpm_tied": dict(arch="minicpm-2b", over={"fsdp": True}, rows=4,
                         seq=16),
    # One kv head: wk/wv held whole over `model`, each rank's q heads
    # reading it.
    "qwen_mqa": dict(arch="qwen3-8b", over={"n_kv_heads": 1}, rows=4,
                     seq=16),
}
#: name → arch and overrides of the eval forwards held to JAX's where the
#: model axis is split: the ten archs, and attention's and RWKV's other
#: splits (wk/wv held whole; q heads off the GQA groups, kv repeated; the
#: row-parallel fallback; RWKV heads that do not divide the axis).
EVALS = {
    **{a: dict(arch=a, over={}) for a in (
        "jamba-v0.1-52b", "whisper-tiny", "arctic-480b", "mixtral-8x22b",
        "minicpm-2b", "command-r-35b", "granite-3-8b", "qwen3-8b",
        "llava-next-34b", "rwkv6-1.6b")},
    "qwen_mqa": dict(arch="qwen3-8b", over={"n_kv_heads": 1}),
    "qwen_gqa3": dict(arch="qwen3-8b", over={"n_heads": 6,
                                             "n_kv_heads": 3}),
    "qwen_rows": dict(arch="qwen3-8b", over={"n_heads": 1, "n_kv_heads": 1,
                                             "fsdp": True}),
    "rwkv_one_head": dict(arch="rwkv6-1.6b", over={},
                          rwkv={"head_size": 64}),
}
EVAL_ROWS, EVAL_SEQ = 4, 16
#: The dry-run test's cut (`tests/test_torch_dryrun.py`).
FLOPS_CUT = dict(arch="granite-3-8b", blocks=3, batch=4, seq=64)
STEPS = 2
LR = (3e-3, 2, 10)  # warmup_cosine(peak, warmup, total)


def case_cfg(get_config, name, cases=None):
    """The case's config (of ``cases``, default `CASES`) from
    ``get_config`` (either package's)."""
    case = (CASES if cases is None else cases)[name]
    cfg = get_config(case["arch"], smoke=True)
    over = {"compute_dtype": "float32", **case["over"]}
    for key in ("moe", "rwkv"):
        if case.get(key):
            over[key] = dataclasses.replace(getattr(cfg, key), **case[key])
    return dataclasses.replace(cfg, **over)


def unflatten(flat: dict, prefix: str) -> dict:
    """The keys of ``flat`` under ``prefix/`` as a nested dict."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def flatten(tree: dict, prefix: str) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(value)
    return out


def gathered(state) -> dict:
    """The state's full parameters and moments as JAX's trees (rank 0; the
    other ranks take part and get empty trees)."""
    from repro_torch.models.weights import stack_to_tree

    place = state.placement
    out = {}
    for key, named in (("params", dict(state.model.named_parameters())),
                       ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"])):
        full = {n: place.full(n, t).detach().clone() for n, t in
                named.items()}
        out[key] = stack_to_tree(full) if place.mesh.rank == 0 else {}
    return out


def main() -> int:
    rank, world, model_ax = (int(a) for a in sys.argv[1:4])
    store = sys.argv[4]
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        if sys.argv[5] == "flops":
            count_flops(rank, model_ax, sys.argv[6])
        else:
            path_in, path_out, ckpt = sys.argv[5:8]
            run(rank, model_ax, path_in, path_out, ckpt)
    finally:
        dist.destroy_process_group()
    return 0


def count_flops(rank, model_ax, path_out) -> None:
    """One train step of `FLOPS_CUT` over the mesh under the dry run's
    FLOP counter; rank 0 writes its count."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import flop_counter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state, make_train_step

    cut = FLOPS_CUT
    cfg = dataclasses.replace(get_config(cut["arch"], smoke=True),
                              n_blocks=cut["blocks"])
    mesh = make_host_mesh(model=model_ax, device="cpu")
    opt = AdamWConfig()
    state = init_state(torch.Generator().manual_seed(0), cfg, opt,
                       mesh=mesh)
    step = make_train_step(cfg, opt, mesh)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (cut["batch"], cut["seq"]))
    with flop_counter() as fc:
        step(state, {"tokens": tokens})
    if rank == 0:
        np.savez(path_out, flops=np.asarray(fc.get_total_flops()))


def run_evals(given, out, mesh, rank) -> None:
    """`EVALS` through ``make_eval_step`` over ``mesh``: rank 0 keeps the
    global logits, the metrics and the labels of the model axis's
    all-gathers."""
    from repro_torch.configs import get_config
    from repro_torch.models.weights import params_from_jax
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding.collectives import recording
    from repro_torch.train import TrainState, make_eval_step, shard_state

    for name in EVALS:
        cfg = case_cfg(get_config, name, EVALS)
        tree = unflatten(given, f"eval/{name}")
        model = params_from_jax(tree["params"], cfg, device="cpu")
        state = TrainState(model=model,
                           opt_state=adamw_init(model, AdamWConfig()),
                           step=torch.zeros((), dtype=torch.int32))
        shard_state(state, mesh)
        batch = {k: torch.from_numpy(v) for k, v in tree["batch"].items()}
        with recording() as record:
            m = make_eval_step(cfg, mesh=mesh, logits=True)(state, batch)
        if rank == 0:
            out[f"eval/{name}/logits"] = m.pop("logits").numpy()
            for key, v in m.items():
                out[f"eval/{name}/metrics/{key}"] = np.asarray(float(v))
            out[f"eval/{name}/gathered"] = np.asarray(sorted(
                {label for kind, _, label in record if kind == "all-gather"
                 and label and label.startswith("model:")}) or [""])


def run(rank, model_ax, path_in, path_out, ckpt) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.weights import (opt_state_from_jax,
                                            params_from_jax)
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import TrainState, make_train_step, shard_state

    mesh = make_host_mesh(model=model_ax, device="cpu")
    with np.load(path_in) as f:
        given = dict(f)
    out = {}
    for name, case in CASES.items():
        cfg = case_cfg(get_config, name)
        opt = AdamWConfig(lr=warmup_cosine(*LR))
        step_fn = make_train_step(cfg, opt, mesh,
                                  microbatch=case.get("micro"),
                                  orthogonal_update=bool(case.get("orth")),
                                  device="cpu")
        for s in range(STEPS):
            tree = unflatten(given, f"{name}/{s}")
            model = params_from_jax(tree["params"], cfg, device="cpu")
            state = TrainState(
                model=model, opt_state=opt_state_from_jax(tree["opt"],
                                                          model),
                step=torch.tensor(int(tree["step"]), dtype=torch.int32))
            shard_state(state, mesh)
            batch = {k: torch.from_numpy(v)
                     for k, v in tree["batch"].items()}
            _, metrics = step_fn(state, batch)
            full = gathered(state)
            if rank == 0:
                for key, t in full.items():
                    out.update(flatten(t, f"{name}/{s}/{key}"))
                for key, v in metrics.items():
                    out[f"{name}/{s}/metrics/{key}"] = np.asarray(float(v))
                out[f"{name}/{s}/step"] = np.asarray(int(state.step))
            if ckpt != "-" and name == next(iter(CASES)) and s == 0:
                check_checkpoint(state, full, ckpt, cfg, opt, mesh, rank)
    if model_ax > 1:
        run_evals(given, out, mesh, rank)
    if rank == 0:
        np.savez(path_out, **out)


def check_checkpoint(state, full, ckpt, cfg, opt, mesh, rank) -> None:
    """Save ``state`` at step 1 from every rank, restore it into a zeroed
    state sharded over the same mesh, and hold the gathered restore to
    ``full`` bit for bit (rank 0)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, shard_state

    mgr = CheckpointManager(ckpt)
    mgr.save(1, state, blocking=True)
    dist.barrier()
    model = Transformer(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    target = TrainState(model=model, opt_state=adamw_init(model, opt),
                        step=torch.zeros((), dtype=torch.int32))
    shard_state(target, mesh)
    mgr.restore(1, target)
    back = gathered(target)
    assert int(target.step) == int(state.step)
    if rank == 0:
        for key in full:
            a = flatten(full[key], key)
            b = flatten(back[key], key)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


if __name__ == "__main__":
    sys.exit(main())
