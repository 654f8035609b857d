"""Fault-tolerant training driver.

The port of the JAX package's ``launch/train.py``, on one device or over
the ranks of a process group:

  * **Auto-resume**: restores the latest checkpoint in --ckpt-dir (atomic
    files only — a crash mid-write leaves the previous checkpoint intact) and
    deterministically skips the data stream to the restored step. The
    checkpoints are in the JAX package's layout, so a run of either package
    resumes the other's.
  * **Elastic restore**: a checkpoint holds full leaves; each rank keeps
    its slice of them, so a run resumes on any mesh (a different number
    of ranks, a different data/model split) or on one device.
  * **Preemption safety**: SIGTERM/SIGINT triggers a final blocking save
    before exit.
  * **Straggler watchdog**: logs any step slower than --watchdog-factor ×
    the running median.
  * **Non-finite loss**: halts with rc 2 before the checkpoint is poisoned.
  * **Gradient compression** (--grad-compression): error-feedback int8 for
    a cross-pod all-reduce; a mesh without a ``pod`` axis logs the flag and
    skips it, and the JAX driver's step never applies it, nor does this
    one's.
  * **Beyond-paper**: --orthogonal-update routes the gradients through the
    paper's TSQR machinery (`repro_torch.optim.orthogonal`).

--device picks the device (default: the card; ``--device cpu`` runs the
plain PyTorch path). Started by ``torchrun`` (``WORLD_SIZE`` > 1 in the
environment), every rank joins the process group (NCCL on the card,
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and trains its slice of
the state (`repro_torch.train.step`): ``--mesh host`` is (world /
``--model-parallel``, ``--model-parallel``) over ``("data", "model")``
(a model axis that does not divide the world raises `ValueError`), ``--mesh
single|multi`` the production mesh, which needs a world of exactly 256 or
512 ranks and raises on any other. Logs, the watchdog and the resume
message come from rank 0; every rank stops with rc 2 on a non-finite
loss (the loss is the global batch's, alike on every rank). The token
pipeline gives tokens only, as the JAX driver's: whisper-tiny's and
llava-next-34b's first step fails with a `KeyError` naming the
``frames`` or ``patches`` its batch lacks, as the JAX driver's does.

Usage (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-8b --smoke --steps 100 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --model-parallel 2 --arch qwen3-8b --smoke --steps 10 \\
      --batch 8 --seq 32
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import statistics
import sys
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine, wsd
from repro_torch.train.step import init_state, make_train_step


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size of the host mesh")
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--orthogonal-update", action="store_true")
    ap.add_argument("--grad-compression", action="store_true",
                    help="error-feedback int8 cross-pod gradient all-reduce "
                         "(requires a `pod` mesh axis; logged otherwise)")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card; 'cpu' "
                         "runs the plain PyTorch path)")
    return ap


def _join_world(device: torch.device) -> None:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1 in
    the environment), unless one exists."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    _join_world(device)

    if args.mesh == "host":
        mesh = make_host_mesh(model=args.model_parallel, device=device)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device)
    device = mesh.device
    lead = mesh.rank == 0

    def say(*parts, **kw):
        if lead:
            print(*parts, **kw)

    sched = (warmup_cosine(args.lr, args.warmup, args.steps) if
             args.schedule == "cosine" else
             wsd(args.lr, args.warmup, int(args.steps * 0.6),
                 int(args.steps * 0.4 - args.warmup)))
    opt_cfg = AdamWConfig(lr=sched)
    step_fn = make_train_step(
        cfg, opt_cfg, mesh, microbatch=args.microbatch or None,
        orthogonal_update=args.orthogonal_update, device=device)
    if args.grad_compression and "pod" not in mesh.shape:
        say("[train] --grad-compression requested but mesh has no `pod` "
            "axis; skipping (single-pod all-reduce stays full-precision)")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(gen, cfg, opt_cfg, device=device, mesh=mesh)

    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored is not None:
            start_step, state = restored
            say(f"[train] resumed from step {start_step} "
                f"(restored onto {device}, mesh {mesh.shape})")

    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, seed=args.seed)
    stream = pipe.start(start_step)

    # Preemption: save-and-exit on SIGTERM/SIGINT.
    preempted = {"flag": False}

    def _sig(_signo, _frame):
        preempted["flag"] = True

    handlers = {s: signal.signal(s, _sig)
                for s in (signal.SIGTERM, signal.SIGINT)}

    step_times: list[float] = []
    losses: list[float] = []
    t_train0 = time.time()
    done = start_step
    try:
        for cur in range(start_step, args.steps):
            batch = next(stream)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # realizes the step
            dt = time.time() - t0
            losses.append(loss)
            if len(step_times) >= 5:
                med = statistics.median(step_times)
                if dt > args.watchdog_factor * med:
                    say(f"[watchdog] step {cur} took {dt:.2f}s "
                        f"(median {med:.2f}s) — straggler suspected")
            step_times.append(dt)
            if not math.isfinite(loss):
                say(f"[train] non-finite loss at step {cur}; "
                    "halting before the checkpoint is poisoned")
                return 2
            done = cur + 1
            if done % args.log_every == 0:
                tput = args.batch * args.seq / max(dt, 1e-9)
                say(f"step {done:5d}  loss {loss:.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"lr {float(metrics['lr']):.2e}  "
                    f"{dt * 1e3:.0f} ms  {tput:.0f} tok/s", flush=True)
            if mgr is not None and done % args.ckpt_every == 0:
                mgr.save(done, state,
                         extra_meta={"arch": cfg.name, "device": str(device)})
            if preempted["flag"]:
                say(f"[train] preemption signal at step {done}; "
                    "writing final checkpoint")
                break
    finally:
        pipe.stop()
        for s, h in handlers.items():
            signal.signal(s, h)
    if mgr is not None:
        mgr.save(done, state, blocking=True,
                 extra_meta={"arch": cfg.name, "final": True})
        mgr.wait()
    if losses:
        say(f"[train] done: steps {start_step}->{done} "
            f"loss {losses[0]:.4f}->{losses[-1]:.4f} "
            f"({time.time() - t_train0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
