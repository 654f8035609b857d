"""The port's flash attention (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode and its ``ref.py``; and, without a
card, what can be checked of the CUDA kernels: which one each dtype takes,
each kernel's shared memory per head dim, and emulations of their
arithmetic.

Tolerances are those of the JAX package's own kernel-vs-oracle test
(tests/test_flash_kernel.py): 2e-5 absolute in float32, 2e-2 in bfloat16.
The bfloat16 emulation is held to the bound the card's checks use for
bfloat16: one bfloat16 step, |got − want| ≤ 2⁻⁷·|want| + 1e-3·rms(want);
the float32 (3xTF32) emulation to the float32 bound, 2e-5 absolute, against
the Pallas kernel.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _flash_mma_emulation as mma_emu
from repro.kernels.flash_attn import ops as jfa_ops
from repro.kernels.flash_attn import ref as jfa_ref
from repro_torch.kernels import _platform
from repro_torch.kernels.flash_attn import kernel as fa_kernel
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn import ref as fa_ref


def _jax_ref_folded(q, k, v, qpos, kpos, causal, window):
    """JAX's oracle on the kernel's folded [B·Hq, T, hd] layout."""
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qh = (q.reshape(b, tq, hkv, g, hd).transpose(0, 2, 3, 1, 4)
          .reshape(b * hkv * g, tq, hd))
    kh = jnp.repeat(k.transpose(0, 2, 1, 3).reshape(b * hkv, tk, hd), g, 0)
    vh = jnp.repeat(v.transpose(0, 2, 1, 3).reshape(b * hkv, tk, hd), g, 0)
    qp = jnp.broadcast_to(qpos[None], (b * hkv * g, tq))
    kp = jnp.broadcast_to(kpos[None], (b * hkv * g, tk))
    out = jfa_ref.flash_attention_ref(qh, kh, vh, qp, kp, causal=causal,
                                      window=window)
    return (out.reshape(b, hkv, g, tq, hd).transpose(0, 3, 1, 2, 4)
            .reshape(b, tq, hq, hd))


def _inputs(rng, b, tq, tk, hq, hkv, hd):
    q = rng.normal(size=(b, tq, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, tk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, tk, hkv, hd)).astype(np.float32)
    qpos = np.arange(tk - tq, tk, dtype=np.int32)
    kpos = np.arange(tk, dtype=np.int32)
    return q, k, v, qpos, kpos


@pytest.mark.parametrize("b,tq,tk,hq,hkv,hd,causal,window", [
    (1, 8, 8, 2, 2, 128, True, None),
    (2, 128, 128, 4, 2, 128, True, None),
    (1, 100, 260, 4, 4, 128, True, None),   # unaligned; tk > tq
    (2, 128, 384, 8, 2, 128, True, 96),     # GQA + sliding window
    (1, 64, 64, 2, 1, 256, False, None),    # non-causal
])
def test_flash_plain_vs_pallas_and_oracle(b, tq, tk, hq, hkv, hd, causal,
                                          window):
    rng = np.random.default_rng(tq * tk + hq)
    q, k, v, qpos, kpos = _inputs(rng, b, tq, tk, hq, hkv, hd)
    jargs = [jnp.asarray(x) for x in (q, k, v, qpos, kpos)]
    out_k = jfa_ops.flash_attention(*jargs, causal=causal, window=window,
                                    block_q=64, block_kv=128)
    out_r = _jax_ref_folded(*jargs, causal, window)
    out_t = fa_ops.flash_attention(*[torch.from_numpy(x) for x in
                                     (q, k, v, qpos, kpos)],
                                   causal=causal, window=window)
    assert out_t.shape == (b, tq, hq, hd) and out_t.dtype == torch.float32
    assert float(np.abs(out_t.numpy() - np.asarray(out_k)).max()) < 2e-5
    assert float(np.abs(out_t.numpy() - np.asarray(out_r)).max()) < 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtypes(dtype):
    rng = np.random.default_rng(0)
    q, k, v, pos, _ = _inputs(rng, 1, 64, 64, 4, 4, 128)
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    out_k = jfa_ops.flash_attention(jq, jk, jv, jnp.asarray(pos),
                                    jnp.asarray(pos), block_q=64, block_kv=64)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(tdt) for x in (jq, jk, jv))
    pos_t = torch.from_numpy(pos)
    out_t = fa_ops.flash_attention(tq, tk, tv, pos_t, pos_t)
    assert out_t.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = np.abs(out_t.float().numpy() - np.asarray(out_k.astype(jnp.float32)))
    assert float(err.max()) < tol


def test_flash_plain_float64_accumulates_in_float64():
    rng = np.random.default_rng(1)
    q, k, v, qpos, kpos = _inputs(rng, 1, 32, 48, 4, 2, 64)
    args = [torch.from_numpy(x.astype(np.float64)) for x in (q, k, v)]
    pos = [torch.from_numpy(x) for x in (qpos, kpos)]
    out = fa_ops.flash_attention(*args, *pos, window=20)
    want = _jax_ref_folded(*[jnp.asarray(x.numpy()) for x in args],
                           jnp.asarray(qpos), jnp.asarray(kpos), True, 20)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-12)


def test_flash_fully_masked_row_gives_zeros():
    """A query row with no visible key (here: every key padded with
    k_pos = −1 before the query's position) is zeros, by the port's pinned
    rule; rows with a visible key are unaffected."""
    rng = np.random.default_rng(2)
    q, k, v, _, _ = _inputs(rng, 1, 6, 6, 2, 1, 32)
    qpos = np.arange(6, dtype=np.int32)
    kpos = np.array([-1, -1, 2, 3, 4, 5], dtype=np.int32)  # rows 0, 1 see none
    args = [torch.from_numpy(x) for x in (q, k, v, qpos, kpos)]
    out = fa_ops.flash_attention(*args).numpy()
    assert np.all(out[:, :2] == 0.0)
    assert np.all(np.isfinite(out))
    want = _jax_ref_folded(*[jnp.asarray(x) for x in (q, k, v, qpos, kpos)],
                           True, None)
    np.testing.assert_allclose(out[:, 2:], np.asarray(want)[:, 2:],
                               atol=2e-5)


def test_flash_plain_needs_no_copies_of_kv_and_counts_no_launch():
    """The plain version folds GQA by broadcasting, and a CPU call is not a
    kernel launch."""
    rng = np.random.default_rng(3)
    q, k, v, qpos, kpos = _inputs(rng, 2, 16, 16, 8, 2, 32)
    _platform.reset_launch_counts()
    out = fa_ref.flash_attention_ref(*[torch.from_numpy(x) for x in
                                       (q, k, v, qpos, kpos)])
    assert out.shape == (2, 16, 8, 32)
    assert _platform.launch_counts().get("flash_attention", 0) == 0


def test_flash_kernel_wrapper_refuses_what_it_cannot_run():
    q = torch.zeros(1, 4, 2, 64)
    pos = torch.arange(4)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, q, q, pos, pos)
    with pytest.raises(TypeError):
        fa_kernel.flash_attention(q.half(), q.half(), q.half(), pos, pos)
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"),
                               pos.to("meta"), pos.to("meta"))


def test_flash_kernel_choice_follows_the_dtype():
    """bfloat16 goes to the sm90 kernel (flash_attn_sm90.cu), float32 and
    float64 to the mma one (flash_attn.cu: float32 on wgmma up to hd 128
    and mma.sync at hd 256, float64 on DMMA); other dtypes are refused."""
    assert fa_kernel.variant(torch.bfloat16) == "sm90"
    assert fa_kernel.variant(torch.float32) == "mma"
    assert fa_kernel.variant(torch.float64) == "mma"
    with pytest.raises(TypeError):
        fa_kernel.variant(torch.float16)


_SM90_SOURCE = (pathlib.Path(fa_kernel.__file__).resolve().parents[2] / "csrc"
                / "flash_attn_sm90.cu")


@pytest.mark.parametrize("hd", fa_kernel.HEAD_DIMS)
def test_flash_sm90_shared_memory_fits_and_matches_the_source(hd):
    """The Python mirror of the bfloat16 kernel's shared memory fits one
    block and agrees with the tile table of the source's note."""
    nbytes = fa_kernel.sm90_smem_bytes(hd)
    assert nbytes <= fa_kernel.SMEM_LIMIT
    bq, bk = fa_kernel.SM90_TILES[hd]
    row = re.search(rf"^//\s+{hd}\s+(\d+)\s+(\d+)\s+\d+ B\s+([\d,]+)",
                    _SM90_SOURCE.read_text(), re.MULTILINE)
    assert row is not None, f"no row for hd {hd} in the source's tile table"
    assert (int(row[1]), int(row[2])) == (bq, bk)
    assert int(row[3].replace(",", "")) == nbytes


def _emulate_sm90(q, k, v, qpos, kpos, split: bool, bk: int = 128):
    """The bfloat16 kernel's arithmetic on the CPU, one KV tile of ``bk`` keys
    at a time: bfloat16 operands, float32 scores and sums, the online
    softmax in base 2, and P·V with P either split into bfloat16 hi and lo
    parts (two products into one float32 sum, as the kernel does) or rounded
    once to bfloat16. Causal masks only."""
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = hd ** -0.5 * 1.4426950408889634
    out = torch.zeros(b, tq, hq, hd)
    for h in range(hq):
        hk = h // (hq // hkv)
        m = torch.full((b, tq, 1), -float("inf"))
        l = torch.zeros(b, tq, 1)
        acc = torch.zeros(b, tq, hd)
        for k0 in range(0, tk, bk):
            kt, vt = kf[:, k0:k0 + bk, hk], vf[:, k0:k0 + bk, hk]
            s = qf[:, :, h] @ kt.transpose(1, 2)
            kp = kpos[k0:k0 + bk][None, None, :]
            ok = (kp >= 0) & (kp <= qpos[None, :, None])
            s = s.masked_fill(~ok, -float("inf"))
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx * c)
            corr = torch.exp2(m * c - base)
            p = torch.exp2(s * c - base)
            l = l * corr + p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            pv = hi @ vt
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vt
            acc = acc * corr + pv
            m = mx
        out[:, :, h] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


def _bf16_step_ratio(got, want):
    """Largest |got − want| over 2⁻⁷·|want| + 1e-3·rms(want) (≤ 1 passes)."""
    want = want.double()
    rms = float(want.square().mean().sqrt())
    diff = (got.double() - want).abs()
    return float((diff / (2.0 ** -7 * want.abs() + 1e-3 * rms)).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_sm90_p_split_keeps_one_bf16_step(seed):
    """Why the kernel splits P: with P = hi + lo the emulated kernel stays
    within one bfloat16 step of the plain version; with P rounded once to
    bfloat16 the short rows at the top of the causal triangle exceed it."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 256, 4, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()  # GQA 4 / 2
    pos = torch.arange(256, dtype=torch.int32)
    want = fa_ref.flash_attention_ref(q, k, v, pos, pos)
    assert _bf16_step_ratio(_emulate_sm90(q, k, v, pos, pos, True), want) <= 1
    assert _bf16_step_ratio(_emulate_sm90(q, k, v, pos, pos, False), want) > 2


_MMA_SOURCE = _SM90_SOURCE.with_name("flash_attn.cu")


@pytest.mark.parametrize("dtype,hd", list(fa_kernel.MMA_TILES))
def test_flash_mma_shared_memory_fits_and_matches_the_source(dtype, hd):
    """The Python mirror of the float32/float64 kernel's tiles and shared
    memory fits one block and agrees with the table of the source's note and
    with its FA_CFG lines."""
    nbytes = fa_kernel.mma_smem_bytes(dtype, hd)
    assert nbytes <= fa_kernel.SMEM_LIMIT
    warps, bk, cols, wgmma = fa_kernel.MMA_TILES[(dtype, hd)]
    assert not wgmma or dtype == torch.float32
    text = _MMA_SOURCE.read_text()
    name = "float" if dtype == torch.float32 else "double"
    row = re.search(rf"^//\s+{name}\s+{hd}\s+(\d+)\s+(\d+)\s+(\d+)"
                    r"\s+(wgmma|mma)\s+([\d,]+)", text, re.MULTILINE)
    assert row is not None, f"no row for {name} hd {hd} in the source's table"
    assert tuple(int(x) for x in row.groups()[:3]) == (warps, bk, cols)
    assert (row[4] == "wgmma") == wgmma
    assert int(row[5].replace(",", "")) == nbytes
    cfg = re.search(rf"^FA_CFG\({name}, {hd}, (\d+), (\d+), (\d+), "
                    r"(true|false)\)", text, re.MULTILINE)
    assert cfg is not None, f"no FA_CFG line for {name} hd {hd}"
    assert tuple(int(x) for x in cfg.groups()[:3]) == (warps, bk, cols)
    assert (cfg[4] == "true") == wgmma


_MMA_CASES = [
    # (b, tq, tk, hq, hkv, hd, causal, window, score scale)
    (1, 1024, 1024, 4, 1, 128, True, None, 1.0),  # causal GQA, the LM's hd
    (2, 384, 384, 8, 2, 128, True, 100, 1.0),     # sliding window
    # scores of large magnitude, up to 33: the softmax nearly one-hot. Much
    # larger, two float32 dot products of the same rows (exact, or XLA's)
    # already differ by the bound before any TF32 rounding.
    (1, 512, 512, 4, 2, 128, True, None, 2.5),
]


def _mma_case(b, tq, tk, hq, hkv, hd, causal, window, amp):
    rng = np.random.default_rng(tq + tk + hd + int(amp))
    q, k, v, qpos, kpos = _inputs(rng, b, tq, tk, hq, hkv, hd)
    q, k = q * np.float32(amp), k * np.float32(amp)
    want = jfa_ops.flash_attention(*[jnp.asarray(x) for x in
                                     (q, k, v, qpos, kpos)],
                                   causal=causal, window=window, block_q=64,
                                   block_kv=128)
    return (q, k, v, qpos, kpos), np.asarray(want)


@pytest.mark.parametrize("case", _MMA_CASES)
def test_flash_mma_3xtf32_emulation_matches_pallas(case):
    """The float32 kernel's 3xTF32 arithmetic, emulated in its order with
    the tensor core's truncating accumulation and ``__expf``
    (`_flash_mma_emulation`), is within the float32 bound of the JAX
    package's Pallas kernel (interpret mode)."""
    *shape, causal, window, amp = case
    args, want = _mma_case(*shape, causal, window, amp)
    got = mma_emu.emulate_mma(*args, causal, window)
    assert float(np.abs(got - want).max()) < 2e-5


def test_flash_mma_tile_sums_keep_long_rows_in_the_bound():
    """Why each tile's P·V goes into a zeroed accumulator: over 4,096 keys
    with V offset by 3, P·V summed straight into O (the kernel's first
    version) drifts toward zero by the tensor core's truncation, outside the
    float32 bound; summed per tile and added in IEEE arithmetic it stays
    inside."""
    rng = np.random.default_rng(7)
    q, k, v, qpos, kpos = _inputs(rng, 1, 128, 4096, 2, 1, 128)
    v = v + np.float32(3)
    args = (q, k, v, qpos, kpos)
    want = np.asarray(jfa_ops.flash_attention(
        *[jnp.asarray(x) for x in args], causal=True, block_q=64,
        block_kv=128))
    tiles = mma_emu.emulate_mma(*args, True, None)
    straight = mma_emu.emulate_mma(*args, True, None, tile_sums=False)
    assert float(np.abs(tiles - want).max()) < 2e-5
    assert float(np.abs(straight - want).max()) > 2e-5


def test_flash_mma_single_tf32_pass_misses_the_bound():
    """Why the kernel splits every operand: one TF32 pass (10 mantissa bits)
    over the same case is far outside the float32 bound."""
    *shape, causal, window, amp = _MMA_CASES[0]
    args, want = _mma_case(*shape, causal, window, amp)
    got = mma_emu.emulate_mma(*args, causal, window, split=False)
    assert float(np.abs(got - want).max()) > 10 * 2e-5
