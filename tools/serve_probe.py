#!/usr/bin/env python3
"""Where a served batch waits: the server's threads, batch by batch.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/serve_probe.py [--scale 4000000] [--concat] [--spin] [--gil]

Serves ``yelp_like(scale, cols=16)`` through
``Session(use_kernel=True, assembly="band").from_tree(...).serve(kind="qr",
max_batch=2)`` (float32), warms buckets 1 and 2, then submits 8 requests
(4 B = 2 batches) while the coalescer is held, twice, and prints each
thread's timeline in ms: submits, coalescing (with ``--concat``), staging,
dispatch, resolve. Then the same 8 requests under torch.profiler: the
host-to-device copies in the trace and the share of their time beside
kernels (`chip_smoke.copy_overlap`).

``--concat`` coalesces each leaf with ``np.concatenate`` before `stage`
(a second host pass into fresh pageable memory) instead of letting `stage`
copy the requests straight into its pinned buffer. ``--spin`` makes the
completion thread wait on a spinning (not blocking-sync) event. ``--gil``
first counts a Python loop's iterations in another thread while this one
waits 0.5 s on an event, blocking in ``Event.synchronize`` and polling
with sleeps: equal counts mean the wait releases the interpreter lock.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def gil_test(wait) -> tuple[int, float]:
    """(iterations another thread's Python loop made, seconds) while this
    thread ran ``wait(event)`` on an event behind ~0.5 s of device sleep."""
    import torch

    torch.cuda.synchronize()
    count, stop = [0], [False]

    def spin():
        while not stop[0]:
            count[0] += 1

    torch.cuda._sleep(1_000_000_000)
    event = torch.cuda.Event()
    event.record()
    thread = threading.Thread(target=spin)
    thread.start()
    t0 = time.perf_counter()
    wait(event)
    seconds = time.perf_counter() - t0
    stop[0] = True
    thread.join()
    return count[0], seconds


def poll(event) -> None:
    while not event.query():
        time.sleep(2e-4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=4_000_000)
    parser.add_argument("--concat", action="store_true")
    parser.add_argument("--spin", action="store_true")
    parser.add_argument("--gil", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch import figaro
    from repro_torch.data.relational import yelp_like
    from repro_torch.train import async_serve as asv

    if args.gil:
        print("Event.synchronize:", gil_test(lambda e: e.synchronize()))
        print("query and sleep:  ", gil_test(poll))

    sess = figaro.Session(use_kernel=True, assembly="band", donate_data=True)
    ds = sess.from_tree(yelp_like(scale=args.scale, cols=16))
    server = ds.serve(kind="qr", max_batch=2, queue_depth=2)
    reqs = cs.request_set(ds.plan, 8, np.float32, np.random.default_rng(0))
    t0, rows, lock = [time.perf_counter()], [], threading.Lock()

    def note(what):
        with lock:
            rows.append(((time.perf_counter() - t0[0]) * 1e3,
                         threading.current_thread().name, what))

    def timed(fn, start, end):
        def run(*a):
            note(start)
            out = fn(*a)
            note(end)
            return out
        return run

    stage = server._engine_stage
    if args.concat:
        def stage_concat(data):
            note("concat start")
            data = tuple(asv._concat(d) if isinstance(d, list) else d
                         for d in data)
            note("concat end")
            return stage(data)
        server._engine_stage = timed(stage_concat, "coalesce", "staged")
    else:
        server._engine_stage = timed(stage, "stage start", "stage end")
    server._dispatch_fn = timed(server._dispatch_fn, "dispatch start",
                                "dispatch end")
    resolve = asv.AsyncFigaroServer._resolve_group
    asv.AsyncFigaroServer._resolve_group = lambda self, *a: timed(
        lambda: resolve(self, *a), "resolve start", "resolved")()
    if args.spin:
        ready = asv._ready_event

        def spinning(out):
            event = ready(out)
            if event is None:
                return None
            spin = torch.cuda.Event()
            spin.record(torch.cuda.current_stream())
            return spin
        asv._ready_event = spinning

    def burst(n, label, show=True):
        rows.clear()
        t0[0] = time.perf_counter()
        server.pause()
        futures = [server.submit(reqs[i]) for i in range(n)]
        note(f"{n} submitted")
        server.resume()
        for f in futures:
            f.result(timeout=600)
        torch.cuda.synchronize()
        print(f"-- {label}: {(time.perf_counter() - t0[0]) * 1e3:.1f} ms")
        if show:
            for at, who, what in rows:
                print(f"   {at:8.1f}  {who[:16]:16s}  {what}")

    for cap in (1, 2):
        for _ in range(2):
            burst(cap, f"warm bucket {cap}", show=False)
    burst(8, "8 requests (4 B = 2 batches)")
    burst(8, "8 requests again")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        burst(8, "8 requests, traced", show=False)
    print("traced:", cs.copy_overlap(cs.device_events(prof)))
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
