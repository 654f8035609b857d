#!/usr/bin/env python3
"""Time the bfloat16 flash kernel against variants of its own source, on the
card, at one qwen3-8b attention layer ([2, 4096] tokens, 32 query / 8 KV
heads, hd 128, causal).

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/flash_sm90_ab.py

Each variant is ``src/repro_torch/csrc/flash_attn_sm90.cu`` with one edit,
built with the package's nvcc flags into ``build/flash_ab/``:

- ``as built``: the source as it is;
- ``exp2f``: the softmax's exponentials by libm's ``exp2f`` in place of the
  hardware's ``ex2.approx`` (why the kernel takes the latter);
- ``P once (timing only)``: without the P_lo product, P rounded once to
  bfloat16 (what the split costs, and how far that output is from the plain
  version: it fails the one-bfloat16-step bound).

Each variant's worst ratio to that bound (|got − want| ≤ 2⁻⁷·|want| +
1e-3·rms(want); ≤ 1 passes) is printed, then the device time per layer
(CUDA events, mean of 20 launches) of every variant and of
``scaled_dot_product_attention`` over four rounds, the order of the variants
reversed every other round. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T, HQ, HKV, HD = 2, 4096, 32, 8, 128
ROUNDS, REPS = 4, 20


def variants(src: str) -> dict[str, str]:
    out = {"as built": src,
           "exp2f": src.replace("exp2_approx(fmaf", "exp2f(fmaf")
                       .replace("exp2_approx(m", "exp2f(m"),
           "P once (timing only)": src.replace(
               "      Mma<HD>::rs(o, p_lo[kk], dv, 1);\n", "")}
    for name, text in out.items():
        if name != "as built" and text == src:
            raise RuntimeError(f"variant {name!r} no longer applies to the "
                               "source")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import ref as fr

    src = (REPO / "src/repro_torch/csrc/flash_attn_sm90.cu").read_text()
    out_dir = REPO / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        jobs[name] = (out_dir / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.fa_sm90_launch.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int64] * 6
                                       + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int64, ctypes.c_void_p])
        lib.fa_sm90_launch.restype = ctypes.c_int
        libs[name] = lib

    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, T, HQ, HD, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, T, HKV, HD, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, T, HKV, HD, generator=g, device="cuda").bfloat16()
    pos = torch.arange(T, device="cuda", dtype=torch.int32)
    out = torch.empty_like(q)

    def launch(lib):
        err = lib.fa_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, T, T, HQ, HKV, HD, 1, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with error {err}")

    def sdpa():
        F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=True,
                                       enable_gqa=True)

    g_sz = HQ // HKV
    want = torch.cat([fr.flash_attention_ref(
        q[:, :, h * g_sz:(h + 1) * g_sz], k[:, :, h:h + 1], v[:, :, h:h + 1],
        pos, pos) for h in range(HKV)], dim=2).double()
    rms = float(want.square().mean().sqrt())
    for name, lib in libs.items():
        launch(lib)
        torch.cuda.synchronize()
        ratio = float(((out.double() - want).abs()
                       / (2.0 ** -7 * want.abs() + 1e-3 * rms)).max())
        print(f"{name}: bound_ratio {ratio:.4f}", flush=True)

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

    times = {name: [] for name in [*libs, "sdpa"]}
    for rnd in range(ROUNDS):
        order = list(libs) if rnd % 2 == 0 else list(reversed(libs))
        for name in order:
            times[name].append(ms(lambda: launch(libs[name])))
        times["sdpa"].append(ms(sdpa))
    for name, ts in times.items():
        print(f"{name}: ms per layer {[round(t, 4) for t in ts]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
