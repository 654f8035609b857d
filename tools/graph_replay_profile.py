#!/usr/bin/env python3
"""Eager against replay of one ``qr``, kernel by kernel, on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/graph_replay_profile.py [--scale 4000000] [--dtype float64]

Builds the main configuration's plan (``yelp_like(scale, cols=16)``), runs
``Session(use_kernel=True, assembly="band").qr`` twice (the first call
eager, the second the capture and its replay), then times, each as the
median of 5 by CUDA events: the same dispatch run eagerly (inside
`FigaroEngine.eager_reference`), the whole replayed dispatch (``sess.qr``),
and the bare graph replay alone (no copy-in, no clone). Then one eager and
one replayed dispatch under torch.profiler, and prints each kernel's device
time and count in both, sorted by the difference. Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import statistics
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def event_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls of ``fn``, each timed by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_times(fn) -> dict:
    """{kernel or copy name: (device ms, count)} over one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key == "figaro.r0_assembly":
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        out[e.key][0] += t / 1e3
        out[e.key][1] += e.count
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=4_000_000)
    parser.add_argument("--dtype", default="float64",
                        choices=("float32", "float64"))
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("graph_replay_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import figaro
    from repro_torch.core.join_tree import build_plan
    from repro_torch.data.relational import yelp_like

    dtype = getattr(torch, args.dtype)
    plan = build_plan(yelp_like(scale=args.scale, cols=16))
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda")
    eng = sess.engine

    def replay():
        return sess.qr(plan, dtype=dtype)

    def eager():
        with eng.eager_reference():
            return sess.qr(plan, dtype=dtype)

    r_first = replay()  # eager
    r_replay = replay()  # the capture and its replay
    (graph,) = eng._graphs.values()

    def bare():
        graph.graph.replay()

    torch.cuda.synchronize()
    print(torch.cuda.get_device_name(0), args.dtype, f"scale {args.scale}")
    print(f"replay equals the first (eager) call bit for bit: "
          f"{torch.equal(r_first, r_replay)}")
    for label, fn in (("eager dispatch", eager), ("replayed dispatch", replay),
                      ("bare graph replay", bare), ("eager dispatch", eager),
                      ("replayed dispatch", replay),
                      ("bare graph replay", bare)):
        fn()
        print(f"{label:20s} {event_ms(fn, 5):9.3f} ms (median of 5, CUDA "
              f"events)")
    k_eager = kernel_times(eager)
    k_replay = kernel_times(replay)
    names = sorted(set(k_eager) | set(k_replay),
                   key=lambda k: -abs(k_replay.get(k, [0, 0])[0]
                                      - k_eager.get(k, [0, 0])[0]))
    total_e = sum(v[0] for v in k_eager.values())
    total_r = sum(v[0] for v in k_replay.values())
    print(f"device time: eager {total_e:.3f} ms over "
          f"{sum(v[1] for v in k_eager.values())}, replay {total_r:.3f} ms "
          f"over {sum(v[1] for v in k_replay.values())}")
    print("   eager ms  count   replay ms  count   diff ms  kernel")
    for name in names[:25]:
        e_ms, e_n = k_eager.get(name, [0.0, 0])
        r_ms, r_n = k_replay.get(name, [0.0, 0])
        print(f"{e_ms:11.3f} {e_n:6d} {r_ms:11.3f} {r_n:6d} "
              f"{r_ms - e_ms:9.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
