#!/usr/bin/env python3
"""Why a gloo rank must end with no thread but its main one.

Run from the root of a checkout, on the CPU::

    python3 tools/gloo_exit_probe.py [--runs 5] [--delay 0.3] [--join]

Each run starts two gloo ranks (one process each, a `FileStore` in a
temporary directory). After a barrier, rank 0 starts a daemon thread that
waits in ``dist.recv`` from rank 1, which never sends, and its main thread
returns; rank 1 exits ``--delay`` seconds after the barrier, which ends
the receive while rank 0's interpreter is being torn down. The thread
then takes the interpreter lock back during its finalization, and the
process aborts with ``terminate called without an active exception``
(exit code 134 or -6): the abort of `tests/_torch_distributed_driver.py`'s
ranks when a server's threads outlived its failed construction. With
``--join`` rank 0 joins the thread (whose receive fails once rank 1 has
gone) before it returns, and exits cleanly. Prints rank 0's exit code per
run and the count of aborts.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import threading
import time


def rank_main(rank: int, store: str, delay: float, join: bool) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dist.barrier()
    if rank == 1:
        time.sleep(delay)
        return

    def wait():
        try:
            dist.recv(torch.zeros(1), src=1, tag=7)
        except RuntimeError:
            pass

    thread = threading.Thread(target=wait, daemon=True)
    thread.start()
    time.sleep(0.2)
    if join:
        thread.join()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--delay", type=float, default=0.3)
    p.add_argument("--join", action="store_true")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.store, args.delay, args.join)
        return 0
    aborts = 0
    for run in range(args.runs):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--store", os.path.join(tmp, "store"),
                   "--delay", str(args.delay)] + (["--join"] * args.join)
            procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(2)]
            logs = [proc.communicate(timeout=120)[0] for proc in procs]
        rc = procs[0].returncode
        aborted = "terminate called without an active exception" in logs[0]
        aborts += aborted
        print(f"run {run}: rank 0 exit code {rc}"
              + (" (terminate called without an active exception)"
                 if aborted else ""), flush=True)
    print(f"{aborts} of {args.runs} runs aborted "
          f"({'thread joined' if args.join else 'daemon thread left'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
