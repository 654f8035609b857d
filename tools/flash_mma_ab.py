#!/usr/bin/env python3
"""Time the float32/float64 flash kernel (``csrc/flash_attn.cu``) against
variants of itself and, optionally, an earlier version of the source, on the
card, at one qwen3-8b attention layer ([2, 4096] tokens, 32 query / 8 KV
heads, hd 128, causal), in float32 and float64.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/flash_mma_ab.py [--old OLD.cu]
                                  [--replace 'NAME@@OLD TEXT@@NEW TEXT' ...]

Each variant is built with the package's nvcc flags into
``build/flash_mma_ab/``: ``as built`` (the source as it is), every
``--replace`` (the source with one text replaced, e.g. another ``FA_CFG``
tile shape) and, with ``--old``, that file (any source with the same
``fa_launch`` entry point, such as the scalar kernel of an earlier
commit). Each is first held to the plain version
(``kernels/flash_attn/ref.py``) on cases that cover every head dim, GQA,
windows, padded keys, packed positions and 4,096 causal keys with V offset
by 3 (a drift of the float32 sums shows there) (2e-5 absolute in float32,
1e-12 in float64), then timed per layer (CUDA events,
mean of ``REPS`` launches) in both dtypes beside
``scaled_dot_product_attention`` over four rounds, the order of the variants
reversed every other round. ptxas's register and spill report of each build
is printed. Exits non-zero without a card or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T, HQ, HKV, HD = 2, 4096, 32, 8, 128
ROUNDS, REPS = 4, 10
DTYPE_CODE = {"float32": 1, "float64": 2}
TOL = {"float32": 2e-5, "float64": 1e-12}
# (b, tq, tk, hq, hkv, hd, causal, window, packed, padded, V offset)
CASES = [(1, 8, 8, 2, 2, 128, True, None, False, False, 0),
         (2, 300, 300, 8, 2, 128, True, None, False, False, 0),
         (1, 100, 260, 4, 4, 64, True, None, False, False, 0),
         (2, 128, 384, 8, 2, 128, True, 96, False, False, 0),
         (1, 64, 64, 2, 1, 256, False, None, False, False, 0),
         (1, 77, 203, 4, 2, 32, True, None, False, False, 0),
         (2, 130, 261, 4, 1, 256, True, 100, False, False, 0),
         (1, 300, 300, 4, 2, 128, True, 40, True, False, 0),
         (1, 200, 400, 8, 2, 64, True, None, False, True, 0),
         (1, 70, 2100, 12, 3, 128, True, None, False, False, 0),
         (1, 4096, 4096, 8, 2, 128, True, None, False, False, 3)]


def build(name: str, src: pathlib.Path, out_dir: pathlib.Path):
    from repro_torch.kernels import _build

    so = out_dir / f"{re.sub(r'[^A-Za-z0-9]+', '_', name)}.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(so), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=pathlib.Path,
                        help="an earlier flash_attn.cu to time beside this one")
    parser.add_argument("--replace", action="append", default=[],
                        help="NAME@@OLD@@NEW: this source with OLD replaced")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_mma_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as fk, ref as fr

    src = REPO / "src/repro_torch/csrc/flash_attn.cu"
    out_dir = REPO / "build" / "flash_mma_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = [("as built", src)]
    for v in args.replace:
        name, old, new = v.split("@@")
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"--replace {name!r}: {old!r} is not in the "
                             "source exactly once")
        path = out_dir / f"{re.sub(r'[^A-Za-z0-9]+', '_', name)}.cu"
        path.write_text(text.replace(old, new))
        specs.append((name, path))
    if args.old is not None:
        specs.append(("old", args.old))
    jobs = {name: build(name, path, out_dir) for name, path in specs}
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name} (left out):\n{log[-3000:]}",
                  flush=True)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        libs[name] = fk.bind(ctypes.CDLL(str(so)))

    def launch(lib, q, k, v, qp, kp, out, causal=True, window=None):
        b, tq, hq, hd = q.shape
        err = lib.fa_launch(
            DTYPE_CODE[str(q.dtype).split(".")[1]], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(), b, tq,
            k.shape[1], hq, k.shape[2], hd, int(causal), int(window is not None),
            0 if window is None else window,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with error {err}")

    ok = True
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        for (b, tq, tk, hq, hkv, hd, causal, window, packed, padded,
             offset) in CASES:
            g = torch.Generator(device="cuda").manual_seed(tq * hd + tk)
            q = torch.randn(b, tq, hq, hd, generator=g, device="cuda", dtype=dt)
            k = torch.randn(b, tk, hkv, hd, generator=g, device="cuda", dtype=dt)
            v = torch.randn(b, tk, hkv, hd, generator=g, device="cuda",
                            dtype=dt) + offset
            qp = torch.arange(tk - tq, tk, device="cuda", dtype=torch.int32)
            kp = torch.arange(tk, device="cuda", dtype=torch.int32)
            if packed:
                kp[170:] -= 170
                qp = kp.clone()
            if padded:
                kp[100:260] = -1
            want = fr.flash_attention_ref(q, k, v, qp, kp, causal=causal,
                                          window=window)
            for lname, lib in libs.items():
                out = torch.full_like(q, float("nan"))
                launch(lib, q, k, v, qp, kp, out, causal, window)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                good = err <= TOL[name]
                ok &= good
                print(f"{lname} {name} b={b} tq={tq} tk={tk} hq={hq} "
                      f"hkv={hkv} hd={hd} causal={causal} window={window}"
                      f"{' packed' if packed else ''}"
                      f"{' padded' if padded else ''}"
                      f"{f' V+{offset}' if offset else ''}: max abs err {err:.3e}"
                      f"{'' if good else ' FAIL'}", flush=True)
    if not ok:
        print("flash_mma_ab: a variant disagrees with the plain version")
        return 1

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    flops = 4 * HD * B * HQ * T * (T + 1) // 2
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        g = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(B, T, HQ, HD, generator=g, device="cuda", dtype=dt)
        k = torch.randn(B, T, HKV, HD, generator=g, device="cuda", dtype=dt)
        v = torch.randn(B, T, HKV, HD, generator=g, device="cuda", dtype=dt)
        pos = torch.arange(T, device="cuda", dtype=torch.int32)
        out = torch.empty_like(q)

        def sdpa():
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        times = {lname: [] for lname in [*libs, "sdpa"]}
        for rnd in range(ROUNDS):
            order = list(libs) if rnd % 2 == 0 else list(reversed(libs))
            for lname in order:
                times[lname].append(ms(lambda: launch(libs[lname], q, k, v,
                                                      pos, pos, out)))
            times["sdpa"].append(ms(sdpa))
        for lname, ts in times.items():
            best = min(ts)
            print(f"{name} {lname}: ms per layer {[round(x, 4) for x in ts]}; "
                  f"{flops / best / 1e9:.1f} TFLOP/s at the best "
                  f"(4·hd flops per visible pair)", flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
