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
saved one bit for bit. Every rank ends with the world's group destroyed.
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
}
STEPS = 2
LR = (3e-3, 2, 10)  # warmup_cosine(peak, warmup, total)


def case_cfg(get_config, name):
    """The case's config from ``get_config`` (either package's)."""
    case = CASES[name]
    cfg = get_config(case["arch"], smoke=True)
    over = {"compute_dtype": "float32", **case["over"]}
    if case.get("moe"):
        over["moe"] = dataclasses.replace(cfg.moe, **case["moe"])
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
    store, path_in, path_out, ckpt = sys.argv[4:8]
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        run(rank, model_ax, path_in, path_out, ckpt)
    finally:
        dist.destroy_process_group()
    return 0


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
