"""One gloo rank of the port's sharded serving tests (no JAX here).

Run one process per rank::

    PYTHONPATH=src python tests/_torch_serve_mesh_driver.py \\
        RANK WORLD MODEL SEQ STORE IN OUT

``tests/test_torch_serve_mesh.py`` spawns WORLD of them for each mesh
shape. Each joins a gloo group through the `FileStore` at STORE (60 s
group timeout), makes the ``("data", "model")`` mesh of shape (WORLD /
MODEL, MODEL) and, for every case of `CASES`, loads the parameters IN
holds (``<case>/params/…``, JAX's tree), shards the model over the mesh
(`repro_torch.train.serve.shard_model`) and runs the port's sharded
``make_prefill`` on the global batch (``<case>/b<B>/batch/…``; SEQ 1:
``shard_seq``, the case's batch of one sequence; SEQ 2: both, in turn)
and `STEPS` decode steps
of the given tokens (``<case>/b<B>/steps``, [STEPS, B, 1]), each rank
feeding its rows. Rank 0 writes to OUT (``.npz``) the global batch's
logits (``<case>/prefill``, ``<case>/decode/<s>``: gathered over the data
ranks), the cache gathered to JAX's layout after the prefill and after the
last step (``<case>/cache/…``, ``<case>/cache_end/…``), and the labels of
the collectives one decode step issued (``<case>/collectives``,
``<kind>|<label>``). Every rank ends with the world's group destroyed.

``… RANK WORLD MODEL SEQ STORE flops OUT`` instead runs one decode step of
`FLOPS_CUT` (the dry-run test's serving cut, in the dry run's cell config)
on a model every rank draws from one seed, under
``repro_torch.launch.dryrun.flop_counter``: rank 0 writes its count
(``flops``) to OUT. ``… axis OUT`` shards qwen3 smoke over the mesh and
runs `Transformer.prefill` and ``decode_step`` straight on the model, its
layers bound to the model axis: rank 0 writes the axis's size (``size``)
and the logits of both (``prefill``, ``decode``).
"""

import dataclasses
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from _torch_train_mesh_driver import flatten, unflatten

#: name → the smoke config's arch and overrides (float32 compute
#: throughout), the prompt's length and the cache's ``max_len``. The ten
#: archs; one kv head (the slots over ``model`` at model 2); one head (the
#: row-parallel fallback); whisper with three heads (row-parallel, its self
#: and cross slots over ``model``); one kv head with ``kv_seq_over_model``
#: off (the head dim over ``model``). mixtral's window of 8 makes a ring
#: that the prompt runs past; over (4, 1) with ``shard_seq`` it is
#: long_500k's layout, its 8 slots 2 a data rank.
CASES = {
    **{a: dict(arch=a, over={}) for a in (
        "jamba-v0.1-52b", "whisper-tiny", "arctic-480b", "mixtral-8x22b",
        "minicpm-2b", "command-r-35b", "granite-3-8b", "qwen3-8b",
        "llava-next-34b", "rwkv6-1.6b")},
    "qwen_mqa": dict(arch="qwen3-8b", over={"n_kv_heads": 1, "fsdp": True}),
    "qwen_rows": dict(arch="qwen3-8b", over={"n_heads": 1, "n_kv_heads": 1}),
    "whisper_rows": dict(arch="whisper-tiny", over={
        "n_heads": 3, "n_kv_heads": 3, "head_dim": 16}),
    "qwen_hd": dict(arch="qwen3-8b", over={"n_kv_heads": 1},
                    kv_seq_over_model=False),
}
PROMPT, MAX_LEN, STEPS = 12, 32, 4
#: The dry-run test's serving cut (`tests/test_torch_dryrun.py`): a decode
#: step of qwen3 smoke over a 64-slot cache.
FLOPS_CUT = dict(arch="qwen3-8b", blocks=3, batch=4, seq=64)


def case_cfg(get_config, name):
    case = CASES[name]
    cfg = get_config(case["arch"], smoke=True)
    return dataclasses.replace(cfg, compute_dtype="float32", **case["over"])


def batch_rows(shard_seq: bool) -> int:
    """The global batch of a world: one sequence under ``shard_seq``."""
    return 1 if shard_seq else 2


def main() -> int:
    rank, world, model_ax, seq = (int(a) for a in sys.argv[1:5])
    store = sys.argv[5]
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        if sys.argv[6] == "flops":
            count_flops(rank, model_ax, sys.argv[7])
        elif sys.argv[6] == "axis":
            on_the_axis(rank, model_ax, sys.argv[7])
        else:
            run(rank, model_ax, seq, sys.argv[6], sys.argv[7])
    finally:
        dist.destroy_process_group()
    return 0


def count_flops(rank, model_ax, path_out) -> None:
    """One decode step of `FLOPS_CUT` over the mesh under the dry run's
    FLOP counter, after a one-token prefill; rank 0 writes its count."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_config, flop_counter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.serve import (make_decode_step, make_prefill,
                                         shard_model)

    cut = FLOPS_CUT
    mesh = make_host_mesh(model=model_ax, device="cpu")
    cfg = cell_config(
        dataclasses.replace(get_config(cut["arch"], smoke=True),
                            n_blocks=cut["blocks"]),
        ShapeSpec("decode_32k", cut["seq"], cut["batch"], "decode"), mesh)
    model = shard_model(Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)), mesh)
    tokens = np.zeros((cut["batch"], 1), np.int32)
    _, cache = make_prefill(cfg, cut["seq"], mesh=mesh)(model,
                                                        {"tokens": tokens})
    decode = make_decode_step(cfg, mesh=mesh)
    rows = tokens[:cut["batch"] // model.placement.data.size]
    with flop_counter() as fc:
        decode(model, cache, rows)
    if rank == 0:
        np.savez(path_out, flops=np.asarray(fc.get_total_flops()))


def on_the_axis(rank, model_ax, path_out) -> None:
    """`Transformer.prefill` and ``decode_step`` of qwen3 smoke (float32
    compute) sharded over the mesh, called on the model itself."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.serve import shard_model

    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True),
                              compute_dtype="float32")
    mesh = make_host_mesh(model=model_ax, device="cpu")
    model = shard_model(Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(5)), mesh)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, 8)))
    logits, cache = model.prefill({"tokens": tokens}, 16)
    step, _ = model.decode_step(cache, tokens[:, :1])
    if rank == 0:
        np.savez(path_out, size=np.asarray(model.blocks[0][0].mixer.tp.size),
                 prefill=logits.numpy(), decode=step.numpy())


def run(rank, model_ax, seq, path_in, path_out) -> None:
    """SEQ 0: the batch of two over the data ranks; 1: one sequence under
    ``shard_seq``; 2: both, the second's keys under ``<case>/seq/``."""
    out = {}
    for shard_seq in ((False, True) if seq == 2 else (bool(seq),)):
        tag = "seq/" if seq == 2 and shard_seq else ""
        out.update(serve_cases(rank, model_ax, shard_seq, path_in, tag))
    if rank == 0:
        np.savez(path_out, **out)


def serve_cases(rank, model_ax, shard_seq, path_in, tag) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.weights import cache_to_numpy, params_from_jax
    from repro_torch.sharding.collectives import recording
    from repro_torch.train.serve import (gather_cache, make_decode_step,
                                         make_prefill, shard_model)
    from repro_torch.train.step import _rows

    mesh = make_host_mesh(model=model_ax, device="cpu")
    with np.load(path_in) as f:
        given = dict(f)
    b = batch_rows(shard_seq)
    out = {}
    for name, case in CASES.items():
        cfg = case_cfg(get_config, name)
        tree = unflatten(given, name)
        model = shard_model(params_from_jax(tree["params"], cfg,
                                            device="cpu"), mesh)
        data = model.placement.data
        inputs = tree[f"b{b}"]
        prefill = make_prefill(cfg, MAX_LEN, mesh=mesh, shard_seq=shard_seq,
                               kv_seq_over_model=case.get(
                                   "kv_seq_over_model", True))
        decode = make_decode_step(cfg, mesh=mesh)

        def whole(logits):  # the global batch's rows
            return logits if shard_seq else data.gather(logits).flatten(0, 1)

        logits, cache = prefill(model, inputs["batch"])
        keep = {"prefill": whole(logits).numpy()}
        full = cache_to_numpy(gather_cache(cache))
        keep.update(flatten(full, "cache"))
        for s, tok in enumerate(inputs["steps"]):
            tok = torch.from_numpy(tok)
            if not shard_seq:
                tok = _rows({"tokens": tok}, model.placement)["tokens"]
            with recording() as record:
                logits, cache = decode(model, cache, tok)
            keep[f"decode/{s}"] = whole(logits).numpy()
            if s == 1:
                keep["collectives"] = np.asarray(sorted(
                    {f"{kind}|{label or ''}" for kind, _, label in record})
                    or [""])
        keep.update(flatten(cache_to_numpy(gather_cache(cache)),
                            "cache_end"))
        if rank == 0:
            out.update({f"{name}/{tag}{k}": v for k, v in keep.items()})
    return out


if __name__ == "__main__":
    sys.exit(main())
