#!/usr/bin/env python3
"""Hold the float32 flash kernel (``csrc/flash_attn.cu``, 3xTF32) against
its CPU emulation (``tests/_flash_mma_emulation.py``) and both against a
float64 oracle, on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/flash_mma_emulation_check.py

Three causal float32 cases, inputs drawn by numpy from fixed seeds: GQA at
the LM's hd 128 over 1,024 keys; scores of large magnitude (Q and K scaled
by 2.5); the last 512 rows over 4,096 keys with V offset by 3, where a
drift of the float32 sums shows. For each it prints the largest absolute
difference of the kernel and of the emulation (one truncation per
tensor-core instruction, and the more lossy one per four products) from
the plain version in float64, and of the kernel from each emulation with
the share of outputs that agree bit for bit. Exits non-zero without a card
or when the kernel is outside the float32 bound (2e-5 absolute).
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
# (name, seed, b, tq, tk, hq, hkv, hd, score scale, V offset)
CASES = [("causal GQA, 1,024 keys", 1, 1, 1024, 1024, 4, 1, 128, 1.0, 0.0),
         ("large scores", 2, 1, 512, 512, 4, 2, 128, 2.5, 0.0),
         ("4,096 keys, V + 3", 3, 1, 512, 4096, 8, 2, 128, 1.0, 3.0)]
TOL = 2e-5


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flash_mma_emulation_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "tests"))
    import _flash_mma_emulation as emu
    from repro_torch.kernels.flash_attn import kernel as fk, ref as fr

    ok = True
    for name, seed, b, tq, tk, hq, hkv, hd, amp, offset in CASES:
        rng = np.random.default_rng(seed)
        q = (rng.normal(size=(b, tq, hq, hd)) * amp).astype(np.float32)
        k = (rng.normal(size=(b, tk, hkv, hd)) * amp).astype(np.float32)
        v = (rng.normal(size=(b, tk, hkv, hd)) + offset).astype(np.float32)
        qpos = np.arange(tk - tq, tk, dtype=np.int32)
        kpos = np.arange(tk, dtype=np.int32)
        dev = [torch.from_numpy(x).cuda() for x in (q, k, v, qpos, kpos)]
        got = fk.flash_attention(*dev, causal=True).cpu().double().numpy()
        want = fr.flash_attention_ref(*(x.double() for x in dev[:3]),
                                      *dev[3:], causal=True).cpu().numpy()
        emus = {g: emu.emulate_mma(q, k, v, qpos, kpos, True, None,
                                   group=g).astype(np.float64)
                for g in (8, 4)}

        def diff(a, c):
            return float(np.abs(a - c).max())

        err = diff(got, want)
        ok &= err <= TOL
        print(f"{name} [b={b}, tq={tq}, tk={tk}, hq={hq}, hkv={hkv}, "
              f"hd={hd}]: kernel − float64 {err:.3e}"
              + "".join(f"; emulation/{g} − float64 {diff(e, want):.3e}, "
                        f"kernel − emulation/{g} {diff(got, e):.3e} "
                        f"({100 * float(np.mean(got == e)):.1f} % equal)"
                        for g, e in emus.items()), flush=True)
    if not ok:
        print(f"flash_mma_emulation_check: the kernel is outside {TOL:g}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
