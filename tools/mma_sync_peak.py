#!/usr/bin/env python3
"""Measure the card's throughput for the two tensor-core instructions the
float32/float64 flash kernel (``csrc/flash_attn.cu``) is built on:
``mma.sync.aligned.m16n8k8`` with TF32 operands (float32 accumulators) and
with float64 operands (DMMA).

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/mma_sync_peak.py

A throwaway kernel (compiled here with the package's nvcc flags into
``build/mma_sync_peak/``) runs, in every warp of 132 x k blocks of 256
threads, a loop of independent m16n8k8 products on registers (8 chains per
warp, no memory traffic); the script prints the rate in TFLOP/s (2·16·8·8
flops per product) for k = 1 and 2 blocks per SM, timed by CUDA events.
These are the ceilings the kernel's tensor work can reach, beside the data
sheet's 494.5 TFLOP/s (TF32, dense) and 67 TFLOP/s (FP64 tensor cores).
Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256) tf32_loop(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256) f64_loop(double* out, int iters) {
  double d[8][4] = {};
  double a[4], b0 = threadIdx.x, b1 = threadIdx.x * 0.5;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
          : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
  }
  double s = 0.0;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int kind, void* out, int blocks, int iters, void* stream) {
  if (kind == 0)
    tf32_loop<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, iters);
  else
    f64_loop<<<blocks, 256, 0, (cudaStream_t)stream>>>((double*)out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_sync_peak: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    out_dir = REPO / "build" / "mma_sync_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "peak.cu", out_dir / "peak.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, name in ((0, "TF32 m16n8k8"), (1, "FP64 m16n8k8")):
        for per_sm in (1, 2):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, device="cuda",
                              dtype=torch.float32 if kind == 0 else torch.float64)
            stream = torch.cuda.current_stream().cuda_stream

            def go():
                err = lib.run(kind, out.data_ptr(), blocks, ITERS, stream)
                if err:
                    raise RuntimeError(f"launch failed with error {err}")

            go()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                go()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            flops = blocks * 8 * ITERS * 8 * 2 * 16 * 8 * 8
            print(f"{name}: {per_sm} block(s) of 8 warps per SM: {ms:.3f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
