#!/usr/bin/env python3
"""Serve qwen3-8b and whisper-tiny over the cards of one host through the
sharded prefill and decode, held to the one-card run.

Run from the root of a checkout on a host with four cards::

    python3 tools/serve_mesh_cards.py [--seed 0] [--parts a,b,c]

One process per card forms an NCCL world of four ranks; each part builds
its ``("data", "model")`` meshes over it (`repro_torch.launch.mesh.
make_host_mesh`) and shards the model over each (`repro_torch.train.
serve.shard_model`), the cache laid out as ``cache_specs`` lays it out:

  * **a** — qwen3-8b, 8 prompts of 2,048 tokens (``chip_smoke.py`` phase
    7c's cut) as (2, 2) and (1, 4): the batch over ``data``, the kv heads
    over ``model`` (8 divide 2 and 4);
  * **b** — qwen3-8b, one prompt of 32,768 tokens as (4, 1) and (2, 2)
    under ``shard_seq``: every rank holds the prompt, the KV slots lie
    over ``data`` (context parallelism), the kv heads over ``model``;
  * **c** — whisper-tiny whole, 8 prompts of 64 tokens after 1,500 frames,
    as (1, 4): its 6 heads do not divide 4, so attention is row-parallel
    and the self and cross caches' slots lie over ``model``, the online
    softmax combined over them.

For each mesh: **hold** — at a cut depth (`HOLD_BLOCKS` of qwen3-8b's 36;
whisper whole) in float32 compute, the prefill's logits and `STEPS`
teacher-forced decode steps' logits (the global batch's rows) against the
mesh-less run on card 0 from the same weights and tokens, each within
`TOL` of its max |logit| over the vocab (the CPU tests' bound, ``tests/
test_torch_serve_mesh.py``; the padding's columns left out); **time** —
the serving cell's configuration
(``repro_torch.launch.dryrun.cell_config``: bf16 parameters, FSDP kept
where 2·N / |model| passes 6 GB, a decode step attending in one block; the
prefill in 1,024-key blocks) at full depth: the prefill and `STEPS` greedy
decode steps, each from a barrier to the step's synchronization on every
rank's host clock (a step's time is the slowest rank's; eager: a graph
over ranks would capture NCCL), each rank's ``max_memory_allocated``, and
the operand bytes of the collectives one decode step and the prefill issue
per kind (`repro_torch.sharding.collectives.recording`); the mesh-less run
on card 0 beside them.

It prints the cards' name and power limit, a JSON line of the results and
writes them to ``chiprun_out/serve_mesh_cards.json``. It exits non-zero
without four cards, when a hold fails, or when a rank does not finish
within `WORKER_TIMEOUT` seconds (it then kills every rank). ``--rehearse``
runs the same code on four gloo ranks on the CPU at the smoke
configurations, as a check of the script.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
HOLD_BLOCKS = 2
STEPS = 32
TOL = 1e-5
WORKER_TIMEOUT = 1500
#: part → (arch, prompt rows, prompt tokens, shard_seq, meshes (D, M))
PARTS = {
    "a": ("qwen3-8b", 8, 2048, False, ((2, 2), (1, 4))),
    "b": ("qwen3-8b", 1, 32768, True, ((4, 1), (2, 2))),
    "c": ("whisper-tiny", 8, 64, False, ((1, 4),)),
}


def _configs(arch: str, rows: int, seq: int, rehearse: bool):
    """(the hold's config, the timed config's base, rows, prompt tokens)."""
    from repro_torch.configs import get_config

    base = get_config(arch, smoke=rehearse)
    if rehearse:
        rows, seq = min(rows, 4), min(seq, 16)
    hold = dataclasses.replace(base, compute_dtype="float32")
    if arch == "qwen3-8b" and not rehearse:
        hold = dataclasses.replace(hold, n_blocks=HOLD_BLOCKS)
    return hold, base, rows, seq


def _inputs(cfg, rows: int, seq: int, seed: int) -> dict:
    """The prompt (and whisper's frames) and the teacher-forced tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(
        np.int32)}
    if cfg.is_enc_dec:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    forced = rng.integers(0, cfg.vocab, (STEPS, rows, 1)).astype(np.int32)
    return batch, forced


def _worker(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.collectives import recording
    from repro_torch.train.serve import (make_decode_step, make_prefill,
                                         shard_model)
    from repro_torch.train.step import _rows

    rank = int(os.environ["RANK"])
    cuda = not args.rehearse
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT),
        **({"device_id": dev} if cuda else {}))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out: dict = {}

    def gen():
        return torch.Generator(device=dev).manual_seed(args.seed)

    def build(cfg, mesh):
        model = Transformer(cfg, device=dev).init(gen())
        return model if mesh is None else shard_model(model, mesh)

    def run(cfg, mesh, batch, forced, max_len, shard_seq, timed,
            solo=False, decode_cfg=None):
        """Prefill and the decode steps: (the global rows' logits, each
        phase's host ms, the peak GB, the collectives of the prefill and
        of one decode step). ``forced`` None: greedy. ``solo``: rank 0
        alone, without a mesh (no barrier)."""
        barrier = (lambda: None) if solo else dist.barrier
        model = build(cfg, mesh)
        prefill = make_prefill(cfg, max_len, dev, mesh=mesh,
                               shard_seq=shard_seq)
        decode = make_decode_step(cfg if decode_cfg is None else decode_cfg,
                                  dev, mesh=mesh)
        data = None if mesh is None or shard_seq else model.placement.data

        def whole(t):
            return t if data is None else data.gather(t).flatten(0, 1)

        def rows(tok):
            tok = torch.as_tensor(tok).to(dev)
            if mesh is not None and not shard_seq:
                tok = _rows({"tokens": tok}, model.placement)["tokens"]
            return tok

        if cuda:
            torch.cuda.empty_cache()
        if timed:  # a warm-up of both, on a short prompt
            short = {k: v[:, :16] if k == "tokens" else v
                     for k, v in batch.items()}
            _, c = prefill(model, short)
            decode(model, c, rows(short["tokens"][:, :1]))
            del c
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        barrier()
        sync()
        t0 = time.perf_counter()
        with recording() as rec_pre:
            logits, cache = prefill(model, batch)
        sync()
        ms = {"prefill": (time.perf_counter() - t0) * 1e3, "decode": []}
        logits_all = [whole(logits).float().cpu()]
        coll = None
        for s in range(STEPS):
            if forced is None:
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            else:
                tok = rows(forced[s])
            barrier()
            sync()
            t0 = time.perf_counter()
            with recording() as rec:
                logits, cache = decode(model, cache, tok)
            sync()
            ms["decode"].append((time.perf_counter() - t0) * 1e3)
            if s == 1:
                coll = collective_bytes(rec)
            logits_all.append(whole(logits).float().cpu())
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
        del model, cache
        if cuda:
            torch.cuda.empty_cache()
        return (logits_all, ms, peak,
                {"prefill": collective_bytes(rec_pre), "decode": coll})

    try:
        for part in args.parts.split(","):
            arch, rows_, seq, shard_seq, meshes = PARTS[part]
            hold_cfg, base, rows_, seq = _configs(arch, rows_, seq,
                                                  args.rehearse)
            batch, forced = _inputs(hold_cfg, rows_, seq, args.seed)
            # The cache's slots: a multiple of 256, so that every slot
            # group's split divides them (else `cache_specs` drops it).
            max_len = -(-(seq + STEPS + 1) // 256) * 256
            res: dict = {"rows": rows_, "prompt": seq,
                         "shard_seq": shard_seq}
            # hold: the mesh-less reference on rank 0's card alone, then
            # each mesh.
            if rank == 0:
                ref = run(hold_cfg, None, batch, forced, max_len, shard_seq,
                          False, solo=True)[0]
            dist.barrier()
            for dims in meshes:
                mesh = make_host_mesh(model=dims[1],
                                      device=None if cuda else "cpu")
                got = run(hold_cfg, mesh, batch, forced, max_len, shard_seq,
                          False)[0]
                if rank == 0:  # the vocab's padding (finfo.min) left out
                    v = hold_cfg.vocab
                    errs = [float((a[:, :v].double() - b[:, :v].double())
                                  .abs().max() / b[:, :v].abs().max())
                            for a, b in zip(got, ref)]
                    res[f"{dims[0]}x{dims[1]}"] = {
                        "hold_rel_err": errs, "hold_ok": max(errs) <= TOL}
            # time: the serving cell's config at full depth, its decode
            # step attending in one block, its prefill in 1,024-key blocks
            # (one block of 32,768 keys would take 137 GB).
            spec = ShapeSpec("decode_32k", max_len, rows_, "decode")

            def timed_cfg(shape):
                return dataclasses.replace(cell_config(base, spec, shape),
                                           attn_block_kv=base.attn_block_kv)

            def decode_cfg(cfg):
                return dataclasses.replace(cfg, attn_block_kv=max_len)

            if rank == 0:
                cfg = timed_cfg({"data": 1, "model": 1})
                _, ms, peak, _ = run(cfg, None, batch, None, max_len,
                                     shard_seq, True, solo=True,
                                     decode_cfg=decode_cfg(cfg))
                res["one_card"] = {"ms": ms, "peak_gb": peak,
                                   "param_dtype": cfg.param_dtype}
            dist.barrier()
            for dims in meshes:
                mesh = make_host_mesh(model=dims[1],
                                      device=None if cuda else "cpu")
                cfg = timed_cfg(dict(mesh.shape))
                _, ms, peak, coll = run(cfg, mesh, batch, None, max_len,
                                        shard_seq, True,
                                        decode_cfg=decode_cfg(cfg))
                every = [None] * WORLD
                dist.all_gather_object(every, {"ms": ms, "peak_gb": peak,
                                               "coll": coll})
                if rank == 0:
                    steps = [max(r["ms"]["decode"][i] for r in every)
                             for i in range(STEPS)]
                    res[f"{dims[0]}x{dims[1]}"].update({
                        "prefill_ms": max(r["ms"]["prefill"] for r in every),
                        "decode_ms": steps,
                        "decode_median_ms": statistics.median(steps),
                        "peak_gb": [r["peak_gb"] for r in every],
                        "collectives": every[0]["coll"],
                        "fsdp": cfg.fsdp, "param_dtype": cfg.param_dtype})
            if rank == 0:
                out[part] = res
                print(json.dumps({part: {k: v for k, v in res.items()
                                         if k != "one_card"}}), flush=True)
        if rank == 0:
            pathlib.Path(args.out).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="a,b,c")
    ap.add_argument("--rehearse", action="store_true",
                    help="gloo ranks on the CPU at the smoke configurations")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    if args.worker:
        _worker(args)
        return 0

    import torch

    if not args.rehearse:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < WORLD:
            print(f"serve_mesh_cards: needs {WORLD} CUDA cards",
                  file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", WORLD_SIZE=str(WORLD))
    with tempfile.TemporaryDirectory() as tmp:
        result = pathlib.Path(tmp) / "result.json"
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", "--port", str(port),
             "--seed", str(args.seed), "--parts", args.parts, "--out",
             str(result)] + (["--rehearse"] if args.rehearse else []),
            cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        logs, failed = [], False
        try:
            for p in procs:
                left = max(1.0, WORKER_TIMEOUT - (time.perf_counter() - t0))
                logs.append(p.communicate(timeout=left)[0])
                failed |= p.returncode != 0
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t0
        if failed or not result.exists():
            for r, text in enumerate(logs):
                print(f"--- rank {r}\n{text[-4000:]}")
            return 1
        out = json.loads(result.read_text())
    out["seconds"] = seconds
    print(json.dumps(out))
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / ("serve_mesh_cards"
             f"{'_rehearsal' if args.rehearse else ''}.json")).write_text(
        json.dumps(out, indent=1))
    ok = True
    for part, res in out.items():
        if part == "seconds":
            continue
        for key, r in res.items():
            if isinstance(r, dict) and "hold_ok" in r:
                ok &= r["hold_ok"]
                extra = "" if "decode_median_ms" not in r else (
                    f"; prefill {r['prefill_ms']:.1f} ms, decode median "
                    f"{r['decode_median_ms']:.2f} ms a step, peak "
                    f"{max(p or 0 for p in r['peak_gb']):.2f} GB a rank, "
                    f"decode collectives {r['collectives']['decode']}")
                print(f"{part} {key}: hold {'ok' if r['hold_ok'] else 'FAILED'}"
                      f" (max rel err {max(r['hold_rel_err']):.3e}){extra}")
        one = res.get("one_card", {})
        if one.get("ms"):
            print(f"{part} one card: prefill {one['ms']['prefill']:.1f} ms, "
                  f"decode median "
                  f"{statistics.median(one['ms']['decode']):.2f} ms a step, "
                  f"peak {one['peak_gb']} GB")
    print(f"{seconds:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
