#!/usr/bin/env python3
"""Train qwen3-8b at its published widths over the cards of one host
through the sharded step, held to the one-card step and set beside the dry
run's forecast of the same cell.

Run from the root of a checkout on a host with N >= 2 cards::

    python3 tools/train_mesh_cards.py [--model-parallel 2] [--seed 0]

One process per card forms an NCCL world of N ranks and the ``("data",
"model")`` mesh of (N / M, M) (`repro_torch.launch.mesh.make_host_mesh`,
M = ``--model-parallel``). With FSDP and remat on, as qwen3-8b's
configuration has them, each rank holds its slice of every
parameter and moment, gathers a super-block's parameters over the data
axis before it runs (again under remat), splits every layer's compute
over the model axis (its heads, ff columns and vocab columns) and
reduce-scatters the gradients. Two parts, each
from the state ``--seed`` draws and on the same global batch of 2 × 4,096
tokens (`repro_torch.data.pipeline.TokenPipeline`):

  * **hold** — `HOLD_BLOCKS` of the 36 blocks in float32 compute, on
    2 × `HOLD_SEQ` tokens (the float64 reference's 2 × 4,096 would not
    fit one card): one step over the mesh and the mesh-less step on card
    0, both from the same state, each held to a **float64 reference** —
    the mesh-less step in float64 compute and state (norms, softmax and
    logits too, `repro_torch.models.layers.wide`) from that state cast to
    float64, on the same batch. The metrics are held within 1e-5 relative
    (``tokens`` exactly); the parameters and moments (the split's gathered
    to rank 0) at rtol 2e-4, atol 2e-6 plus the gradient tolerance `TAU`
    of each leaf's largest carried through the first Adam step (the bound
    of ``tests/_adam_hold.py``: the first step's update lr·g/(|g| + eps)
    is monotone in g, so its slack is the larger of its moves at g ± δg).
    `TAU` is float32's rounding over the step's reduction length:
    8·√K·2⁻²⁴ with K = 2 × `HOLD_SEQ` tokens, the sum every weight's
    gradient is. Beside it, each leaf's max |g − g64| over its largest
    |g64| for both steps (``grad_rel``, ``grad_rel_one``: the gradients
    read off the first moments) and the split's over the one card's,
    which must stay within `SPLIT_FACTOR`: a split adds no rounding of
    another scale.
  * **time** — ``chip_smoke.py`` phase 11a's cut (4 of 36 blocks, bfloat16
    compute, float32 state, remat): the mesh-less step on card 0 first,
    then the mesh step: `TIMED` steps after a warm-up, each timed on every
    rank's host clock from a barrier to the step's synchronization (a
    step's time is the slowest rank's), each rank's
    ``max_memory_allocated``, the operand bytes of the collectives one step
    issues per kind (`repro_torch.sharding.collectives.recording`), and
    rank 0's ``FlopCounterMode`` count of one step. Beside them, the dry
    run of the same cell on the same mesh (``python -m
    repro_torch.launch.dryrun --host-mesh D,M --blocks 4 --batch 2 --seq
    4096 --micro 1``, fake tensors on the CPU, started first in a
    subprocess): its FLOPs and collective bytes, which must equal rank
    0's, and its peak memory a device, which must lie within [0.5, 2] of
    the card's.
  * **micro** — the same cut on `MICRO_ROWS` times the rows, one row a
    data rank per micro-step (the dry run's own choice at 4,096 tokens):
    two steps, each rank's time and ``max_memory_allocated``, against the
    dry run of that cell, whose memory pass runs two of the micro-steps
    and adds the other rows' bytes: its peak must lie within [0.5, 2] of
    the card's.

It prints the card's name and power limit, a JSON line of the results,
and writes them to ``chiprun_out/train_mesh_cards_<D>x<M>.json``. It exits
non-zero without two cards, when a check above fails, or when a rank does
not finish within `WORKER_TIMEOUT` seconds (it then kills every rank).
``--rehearse`` runs the same code on gloo ranks on the CPU at the smoke
configuration (``--world`` ranks), as a check of the script.
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
HOLD_BLOCKS, TIME_BLOCKS = 2, 4
BATCH, SEQ = 2, 4096
HOLD_SEQ = 1024  # the hold's sequence: its float64 step fits one card
TIMED = 3
MICRO_ROWS = 4  # the micro part's global batch, in multiples of BATCH
#: The gradient's tolerance against float64, of a leaf's largest: float32's
#: unit roundoff 2⁻²⁴ over √K, K the tokens a gradient sums over, times 8
#: (the largest of a leaf's millions of errors, and the forward's own
#: rounding that the backward carries).
TAU = 8 * (BATCH * HOLD_SEQ) ** 0.5 * 2.0 ** -24
SPLIT_FACTOR = 4  # the split's error over the one card's, at most
RTOL, ATOL = 2e-4, 2e-6
WORKER_TIMEOUT = 600


def _cfgs(rehearse: bool):
    """(hold config, time config, batch rows, sequence)."""
    from repro_torch.configs import get_config

    base = get_config("qwen3-8b", smoke=rehearse)
    hold = dataclasses.replace(base, n_blocks=HOLD_BLOCKS,
                               compute_dtype="float32", remat=True,
                               fsdp=True)
    timed = dataclasses.replace(base, n_blocks=TIME_BLOCKS)
    return hold, timed, (4 if rehearse else BATCH), (32 if rehearse else SEQ)


def split_faults(g_rel: dict, g_one: dict, tau: float = TAU,
                 factor: float = SPLIT_FACTOR) -> list[str]:
    """The leaves on which the split's gradient is more than ``factor``
    times farther from float64 than the one card's, worst first. Only
    leaves whose split error passes ``tau``/8 (√K·2⁻²⁴) are compared:
    below it the ratio of two roundings says nothing."""
    ratio = {n: g_rel[n] / max(g_one[n], 1e-30) for n in g_rel
             if g_rel[n] > tau / 8}
    return [f"the split is {ratio[n]:.2f}x farther from float64 than the "
            f"one card on {n}"
            for n in sorted(ratio, key=ratio.get, reverse=True)
            if ratio[n] > factor]


def _float64_step(state32, cfg, opt, batch, dev):
    """The mesh-less step in float64 compute and state from ``state32``'s
    parameters cast to float64 (zero moments, as theirs): its (param, mu,
    nu) per leaf on the host, and its metrics."""
    import torch

    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, make_train_step

    cfg64 = dataclasses.replace(cfg, compute_dtype="float64",
                                param_dtype="float64",
                                opt_state_dtype="float64")
    opt64 = dataclasses.replace(opt, state_dtype="float64")
    model = Transformer(cfg64, device=dev)
    with torch.no_grad():
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  state32.items()):
            p.copy_(q.to(dev, torch.float64))
    state = TrainState(model=model, opt_state=adamw_init(model, opt64),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    m = make_train_step(cfg64, opt64, device=dev)(state, batch)[1]
    out = {n: (p.detach().cpu(), state.opt_state["mu"][n].cpu(),
               state.opt_state["nu"][n].cpu())
           for n, p in model.named_parameters()}
    return out, {k: float(v) for k, v in m.items()}


def _hold_leaf(got, ref, *, lr, b1, b2, eps, what, chunk=1 << 25):
    """The first Adam step's bound on one leaf: ``got`` and ``ref`` its
    (param, mu, nu) after the step, the reference's ``mu`` giving the
    clipped gradient g = mu / (1 − b1) (zero moments before the step).
    Float64 on the leaf's device, ``chunk`` elements at a time. Returns the
    violations' messages and max |g_got − g_ref| / max |g_ref| (the
    gradients the two ``mu`` give)."""
    import torch

    got = [t.reshape(-1) for t in got]
    ref = [t.reshape(-1) for t in ref]
    dg = TAU * float(ref[1].abs().max()) / (1 - b1)

    def update(x):  # m̂ = x and v̂ = x² at step 1
        return lr * x / (x.abs() + eps)

    bad_n, worst = [0, 0, 0], [0.0, 0.0, 0.0]
    g_err = 0.0
    for i in range(0, ref[0].numel(), chunk):
        g_err = max(g_err, float((got[1][i:i + chunk].double()
                                  - ref[1][i:i + chunk].double()).abs().max()))
        g = ref[1][i:i + chunk].double() / (1 - b1)
        u = update(g)
        slack = (torch.maximum((update(g + dg) - u).abs(),
                               (update(g - dg) - u).abs()),
                 (1 - b1) * dg, (1 - b2) * 2 * (g.abs() + dg) * dg)
        del g, u
        for j in range(3):
            a = got[j][i:i + chunk].double()
            b = ref[j][i:i + chunk].double()
            err = (a - b).abs()
            bad = err > ATOL + RTOL * b.abs() + slack[j]
            if bool(bad.any()):
                bad_n[j] += int(bad.sum())
                worst[j] = max(worst[j], float(err[bad].max()))
    return [f"{what} {name}: {n} elements beyond the bound, max |diff| "
            f"{w:.3e}" for name, n, w in zip(("p", "mu", "nu"), bad_n, worst)
            if n], g_err / max(float(ref[1].abs().max()), 1e-30)


def _worker(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.dryrun import flop_counter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.sharding.collectives import recording
    from repro_torch.train import init_state, make_train_step

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cuda = not args.rehearse
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORKER_TIMEOUT),
        **({"device_id": dev} if cuda else {}))
    hold_cfg, time_cfg, rows, seq = _cfgs(args.rehearse)
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, 10))
    gen = lambda: torch.Generator(device=dev).manual_seed(args.seed)  # noqa
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out: dict = {}
    try:
        mesh = make_host_mesh(model=args.model_parallel,
                              device=None if cuda else "cpu")
        batch_h = TokenPipeline(hold_cfg.vocab, HOLD_SEQ if cuda else seq,
                                rows, seed=args.seed).batch_at(0)
        batches = [TokenPipeline(time_cfg.vocab, seq, rows,
                                 seed=args.seed).batch_at(s)
                   for s in range(TIMED + 2)]

        # The mesh-less references, on rank 0's card alone: the float32
        # step, then the float64 step from the same state; the float32
        # step held to the float64 one.
        if rank == 0:
            state = init_state(gen(), hold_cfg, opt, device=dev)
            start = {n: p.detach().cpu().clone()
                     for n, p in state.model.named_parameters()}
            step = make_train_step(hold_cfg, opt, device=dev)
            one_m = {k: float(v) for k, v in step(state, batch_h)[1].items()}
            one = {n: (p.detach().cpu(), state.opt_state["mu"][n].cpu(),
                       state.opt_state["nu"][n].cpu())
                   for n, p in state.model.named_parameters()}
            del state, step
            if cuda:
                torch.cuda.empty_cache()
            ref, ref_m = _float64_step(start, hold_cfg, opt, batch_h, dev)
            del start
            if cuda:
                torch.cuda.empty_cache()
            one_msgs, g_one = [], {}
            for n, leaf in one.items():
                bad, g_one[n] = _hold_leaf(
                    [t.to(dev) for t in leaf], [t.to(dev) for t in ref[n]],
                    lr=ref_m["lr"], b1=opt.b1, b2=opt.b2, eps=opt.eps,
                    what=f"one card {n}")
                one_msgs += bad
            one_msgs += [f"one card metric {k}: {one_m[k]} vs {ref_m[k]}"
                         for k in ref_m if abs(one_m[k] - ref_m[k])
                         > (0 if k == "tokens" else 1e-5) * abs(ref_m[k])]
            del one
            state = init_state(gen(), time_cfg, opt, device=dev)
            step = make_train_step(time_cfg, opt, device=dev)
            step(state, batches[0])
            sync()
            ms = []
            for b in batches[1:TIMED + 1]:
                t0 = time.perf_counter()
                step(state, b)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            out["mesh_less_ms"] = ms
            out["mesh_less_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                        / 1e9 if cuda else None)
            del state, step
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()

        # hold: one step over the mesh, gathered to rank 0.
        state = init_state(gen(), hold_cfg, opt, mesh=mesh)
        step = make_train_step(hold_cfg, opt, mesh)
        m = {k: float(v) for k, v in step(state, batch_h)[1].items()}
        place = state.placement
        msgs, leaves, g_rel = [], 0, {}
        for n, p in state.model.named_parameters():
            got = [place.full(n, t) for t in (
                p.detach(), state.opt_state["mu"][n],
                state.opt_state["nu"][n])]
            if rank == 0:
                bad, g_rel[n] = _hold_leaf(
                    got, [t.to(dev) for t in ref[n]], lr=ref_m["lr"],
                    b1=opt.b1, b2=opt.b2, eps=opt.eps, what=n)
                msgs += bad
                leaves += 1
            del got
        if rank == 0:
            rel = {k: abs(m[k] - ref_m[k]) / max(abs(ref_m[k]), 1e-30)
                   for k in ref_m}
            msgs += [f"metric {k}: {m[k]} vs {ref_m[k]}" for k in ref_m
                     if rel[k] > (0 if k == "tokens" else 1e-5)]
            ratio = {n: g_rel[n] / max(g_one[n], 1e-30) for n in g_rel}
            msgs += split_faults(g_rel, g_one)
            msgs += one_msgs
            out["hold"] = {"metrics": m, "reference": ref_m,
                           "metrics_rel": rel, "leaves": leaves,
                           "tau": TAU, "split_factor": SPLIT_FACTOR,
                           "tokens": [rows, int(batch_h["tokens"].shape[1])],
                           "failures": msgs[:20], "ok": not msgs,
                           "grad_rel": g_rel, "grad_rel_one": g_one,
                           "split_over_one": ratio}
            del ref
        del state, step

        # time: 11a's cut over the mesh.
        state = init_state(gen(), time_cfg, opt, mesh=mesh)
        step = make_train_step(time_cfg, opt, mesh)
        step(state, batches[0])
        sync()
        with recording() as record:
            step(state, batches[1])
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for b in batches[2:TIMED + 2]:
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            step(state, b)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
        with flop_counter() as fc:
            step(state, batches[-1])
        sync()
        mine = {"ms": ms, "peak_gb": peak, "flops": fc.get_total_flops(),
                "coll": collective_bytes(record)}
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            slowest = [max(r["ms"][i] for r in every) for i in range(TIMED)]
            out["time"] = {"ranks": every, "step_ms": slowest,
                           "median_ms": statistics.median(slowest),
                           "mesh": dict(mesh.shape)}

        # micro: MICRO_ROWS× the rows, one a data rank per micro-step.
        micro = rows * MICRO_ROWS // mesh.shape["data"]
        step = make_train_step(time_cfg, opt, mesh, microbatch=micro)
        big = [TokenPipeline(time_cfg.vocab, seq, rows * MICRO_ROWS,
                             seed=args.seed).batch_at(s) for s in range(2)]
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for b in big:
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            step(state, b)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
        every = [None] * world
        dist.all_gather_object(every, {"ms": ms, "peak_gb": peak})
        if rank == 0:
            out["micro"] = {"ranks": every, "micro": micro,
                            "rows": rows * MICRO_ROWS,
                            "step_ms": [max(r["ms"][i] for r in every)
                                        for i in range(2)]}
            pathlib.Path(args.out).write_text(json.dumps(out))
        del state, step
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="gloo ranks on the CPU at the smoke configuration")
    ap.add_argument("--world", type=int, default=4,
                    help="ranks of a rehearsal (on the card: every card)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    if args.worker:
        _worker(args)
        return 0

    import torch

    if args.rehearse:
        world = args.world
    else:
        world = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world < 2:
            print("train_mesh_cards: needs two or more CUDA cards",
                  file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    if world % args.model_parallel:
        print(f"train_mesh_cards: --model-parallel {args.model_parallel} "
              f"does not divide {world} ranks", file=sys.stderr)
        return 2
    dims = (world // args.model_parallel, args.model_parallel)
    _, _, rows, seq = _cfgs(args.rehearse)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", WORLD_SIZE=str(world))
    # (rows, micro-steps) of the time and micro parts' cells.
    cells = ((rows, 1), (rows * MICRO_ROWS, rows * MICRO_ROWS // dims[0]))
    with tempfile.TemporaryDirectory() as tmp:
        dry_dir = pathlib.Path(tmp) / "dry"
        drys = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-8b", "--shape", "train_4k", "--host-mesh",
             f"{dims[0]},{dims[1]}", "--blocks", str(TIME_BLOCKS),
             "--batch", str(b), "--seq", str(seq), "--micro", str(m),
             "--out", str(dry_dir / str(m))]
            + (["--smoke"] if args.rehearse else []),
            cwd=REPO, env=dict(env, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for b, m in cells]
        result = pathlib.Path(tmp) / "result.json"
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", "--port", str(port),
             "--model-parallel", str(args.model_parallel), "--seed",
             str(args.seed), "--out", str(result)]
            + (["--rehearse"] if args.rehearse else []),
            cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs, failed = [], False
        try:
            for p in procs:
                left = max(1.0, WORKER_TIMEOUT - (time.perf_counter() - t0))
                logs.append(p.communicate(timeout=left)[0])
                failed |= p.returncode != 0
            dry_logs = [d.communicate(timeout=WORKER_TIMEOUT)[0]
                        for d in drys]
        finally:
            for p in procs + drys:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t0
        if failed or not result.exists():
            for r, text in enumerate(logs):
                print(f"--- rank {r}\n{text[-4000:]}")
            return 1
        out = json.loads(result.read_text())
        recs = [sorted((dry_dir / str(m)).glob("*.json")) for _, m in cells]
        if any(d.returncode for d in drys) or not all(recs):
            print("\n".join(text[-4000:] for text in dry_logs))
            return 1
        rec, rec_micro = (json.loads(r[0].read_text()) for r in recs)
    t = out["time"]
    r0 = t["ranks"][0]
    out["dryrun"] = {k: rec.get(k) for k in (
        "status", "flops_per_device", "coll_breakdown",
        "coll_bytes_per_device", "peak_memory_per_device", "step_s",
        "dominant")}
    out["vs_dryrun"] = {
        "flops_equal": rec.get("flops_per_device") == r0["flops"],
        "coll_equal": {k: rec["coll_breakdown"].get(k) == v
                       for k, v in r0["coll"].items()},
        "peak_ratio": (None if r0["peak_gb"] is None else
                       rec["peak_memory_per_device"] / 1e9 / r0["peak_gb"]),
        "micro_peak_ratio": (
            None if r0["peak_gb"] is None else
            rec_micro["peak_memory_per_device"] / 1e9
            / out["micro"]["ranks"][0]["peak_gb"]),
    }
    out["dryrun_micro"] = {k: rec_micro.get(k) for k in (
        "status", "peak_memory_per_device", "memory_analysis")}
    out["seconds"] = seconds
    out["world"], out["dims"] = world, dims
    print(json.dumps(out))
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / (f"train_mesh_cards_{dims[0]}x{dims[1]}"
             f"{'_rehearsal' if args.rehearse else ''}.json")).write_text(
        json.dumps(out, indent=1))
    vs = out["vs_dryrun"]
    ok = out["hold"]["ok"] and vs["flops_equal"] and all(
        vs["coll_equal"].values()) and all(
        r is None or 0.5 <= r <= 2.0
        for r in (vs["peak_ratio"], vs["micro_peak_ratio"]))
    g_rel = out["hold"]["grad_rel"]
    worst = max(g_rel, key=g_rel.get)
    print(f"hold {'ok' if out['hold']['ok'] else 'FAILED'}: "
          f"{out['hold']['failures']}; gradients within "
          f"{g_rel[worst]:.3e} of a leaf's largest ({worst}); mesh step "
          f"median "
          f"{t['median_ms']:.1f} ms over {dims}, mesh-less "
          f"{statistics.median(out['mesh_less_ms']):.1f} ms; FLOPs and "
          f"collective bytes equal to the dry run's: "
          f"{out['vs_dryrun']['flops_equal']}, "
          f"{all(out['vs_dryrun']['coll_equal'].values())}; dry-run peak "
          f"over the card's {vs['peak_ratio']}, with {cells[1][1]} "
          f"micro-steps {vs['micro_peak_ratio']}; {seconds:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
