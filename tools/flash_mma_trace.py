#!/usr/bin/env python3
"""Where the time of the float32/float64 flash kernel goes, on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/flash_mma_trace.py

Builds ``src/repro_torch/csrc/flash_attn.cu`` as it is and with
``-DFA_TRACE`` (the package's nvcc flags otherwise) into
``build/flash_mma_trace/``. With the trace, lane 0 of every warp sums the
clock cycles its warp spends in each phase of the tile loop. Runs one
qwen3-8b attention layer ([2, 4096] tokens, 32 query / 8 KV heads, hd 128,
causal, the shape of the float32 eval path's calls) in float32 and float64,
and prints the untraced and traced times per layer (CUDA events, mean of 10
launches) and each phase's share of the warps' summed cycles: waiting for
a K/V stage and the barrier after it ("wait"; the prologue with Q's load
falls here too), splitting the stage into TF32 hi and lo parts ("split",
float32 only), the barrier after the split, the visible-tile scan and
issuing the next stage's copies ("refill"), Q·Kᵀ ("qk"), the online
softmax ("softmax"), P·V ("pv") and the epilogue ("store"). Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T, HQ, HKV, HD = 2, 4096, 32, 8, 128
PHASES = ["wait", "split", "refill", "qk", "softmax", "pv", "store"]
REPS = 10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_mma_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as fk

    src = REPO / "src/repro_torch/csrc/flash_attn.cu"
    out_dir = REPO / "build" / "flash_mma_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in (("plain", []), ("trace", ["-DFA_TRACE"])):
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = fk.bind(ctypes.CDLL(str(so)))
    take = libs["trace"].fa_trace_take
    take.argtypes = [ctypes.c_void_p]
    take.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * len(PHASES))()

    for code, dt in ((1, torch.float32), (2, torch.float64)):
        g = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(B, T, HQ, HD, generator=g, device="cuda", dtype=dt)
        k = torch.randn(B, T, HKV, HD, generator=g, device="cuda", dtype=dt)
        v = torch.randn(B, T, HKV, HD, generator=g, device="cuda", dtype=dt)
        pos = torch.arange(T, device="cuda", dtype=torch.int32)
        out = torch.empty_like(q)

        def launch(lib):
            err = lib.fa_launch(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
                                B, T, T, HQ, HKV, HD, 1, 0, 0,
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with error {err}")

        times = {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                launch(lib)
            end.record()
            torch.cuda.synchronize()
            times[name] = start.elapsed_time(end) / REPS
        if take(sums):
            raise RuntimeError("reading the trace failed")
        launch(libs["trace"])
        torch.cuda.synchronize()
        if take(sums):
            raise RuntimeError("reading the trace failed")
        total = sum(sums)
        shares = ", ".join(f"{p} {100 * sums[i] / total:.1f}%"
                           for i, p in enumerate(PHASES))
        print(f"{str(dt).split('.')[1]}: {times['plain']:.3f} ms per layer "
              f"({times['trace']:.3f} ms traced); warp cycles {total:.4e}: "
              f"{shares}", flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
