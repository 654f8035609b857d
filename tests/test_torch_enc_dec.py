"""The port's encoder-decoder (whisper-tiny) and patch (llava-next-34b)
configs against the JAX package's, on the CPU.

The same weights (JAX's ``init_params``, carried across as numpy) and the
same inputs (numpy, seeded: tokens, and the ``frames`` or ``patches``
`_lm_parity.inputs` draws) go through JAX's ``attention(cross=True)``,
``forward``, ``loss_fn``/``jax.grad``, ``prefill``/``decode_step``,
``make_train_step`` and checkpoint manager and the port's. JAX runs as the
suite runs it (x64 on, CPU; its flash kernel in interpret mode). Float32
compute throughout, at the smoke configs. Tolerances: the cross branch
within 1e-5 of its max |y|; logits, prefill and decode within
`tests/test_torch_lm.py`'s 1e-4 of max |logits|, caches leaf by leaf at
the same bound (positions exactly); gradients at
``tests/test_torch_train.py``'s bound (loss within 1e-5 relative, each
leaf within 1e-5 of its max |g|); three train steps through `_adam_hold`
with the gradient's 1e-6 of each leaf's largest; checkpoints bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import serve as jserve
from repro.train import step as jstep
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import layers
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import (opt_state_to_numpy, params_from_jax,
                                        params_to_numpy)
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_state, make_train_step, serve

ENC_DEC_ARCHS = ("whisper-tiny", "llava-next-34b")


# -- the cross branch ------------------------------------------------------------


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_jax(cached, qk_norm):
    """``Attention(cross=True)`` over an encoder output of 40 keys (past
    ``attn_block_kv`` 16, so both take the blockwise branch), or over a
    cache holding K/V: JAX's branch, which applies ``k_norm`` to the
    projected K and not to a cached one. The cache comes back as it was
    given, unwritten."""
    jcfg, tcfg = lp.cfgs("whisper-tiny", qk_norm=qk_norm, attn_block_kv=16)
    p = jlayers.init_attention(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(5)
    if qk_norm:  # scales away from 1, so a norm applied or not shows
        p = dict(p, q_norm=jnp.asarray(rng.uniform(0.5, 1.5, 16),
                                       jnp.float32),
                 k_norm=jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32))
    attn = layers.Attention(tcfg, device="cpu")
    with torch.no_grad():
        for name, w in attn.named_parameters():
            w.copy_(torch.from_numpy(np.array(p[name])))
    x = rng.standard_normal((2, 5, tcfg.d_model), np.float32)
    enc = rng.standard_normal((2, 40, tcfg.d_model), np.float32)
    pos = np.arange(7, 12)
    cache = None
    if cached:
        kv = rng.standard_normal((2, 2, 40, tcfg.n_kv_heads, 16), np.float32)
        cache = {"k": kv[0], "v": kv[1]}
    y_j, c_j = jlayers.attention(
        p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), causal=False,
        cross=True, kv_x=None if cached else jnp.asarray(enc),
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    with torch.no_grad():
        y_t, c_t = attn(torch.from_numpy(x), tcfg,
                        positions=torch.from_numpy(pos), causal=False,
                        cross=True, kv_x=None if cached else
                        torch.from_numpy(enc), cache=tc)
    assert c_t is tc and (c_j is None) == (tc is None)
    if cached:
        for k in ("k", "v"):
            np.testing.assert_array_equal(tc[k].numpy(), cache[k])
    assert y_t.shape == y_j.shape and y_t.dtype == torch.float32
    assert lp.rel(y_t.numpy(), y_j) < 1e-5
    if not cached:  # the branch's cache K/V are the projection's, unnormed
        with torch.no_grad():
            k, v = attn.cross_kv(torch.from_numpy(enc), tcfg)
        want = jnp.einsum("btd,dhk->bthk", jnp.asarray(enc), p["wk"])
        assert lp.rel(k.numpy(), want) < 1e-6
        assert k.shape == v.shape == (2, 40, tcfg.n_kv_heads, 16)


# -- the whole model -------------------------------------------------------------

arch = lp.arch_fixture(ENC_DEC_ARCHS)


def test_forward_and_offset_match_jax(arch):
    """Logits over 24 tokens, after llava's 8 patches (offset 8) or with
    whisper's 16 frames (offset 0)."""
    lp.forward_and_aux(arch, 24)


def test_loss_gradients_match_jax(arch):
    """Autograd of the port's ``loss_fn`` against ``jax.grad`` at 24
    tokens: every leaf, the encoder's, ``enc_pos``, ``enc_norm``, the
    cross-attention's and its ``norm_x``, and ``patch_proj`` among them."""
    names = lp.loss_gradients(arch, 24, 1e-5)
    want = {"whisper-tiny": ("encoder/pos0/mixer/wq", "encoder/pos0/mlp/w_up",
                             "encoder/pos0/norm1/bias", "enc_pos",
                             "enc_norm/scale", "blocks/pos0/cross/wk",
                             "blocks/pos0/cross/wo",
                             "blocks/pos0/norm_x/scale"),
            "llava-next-34b": ("patch_proj",)}[arch["name"]]
    assert set(want) <= names


@pytest.mark.parametrize("prompt,frames", [(9, None), (3, 12)])
def test_prefill_and_decode_match_jax(arch, prompt, frames):
    """Prefill ``prompt`` tokens, then 6 teacher-forced decode steps:
    logits and every cache leaf, the ``cross`` kind's too, after each call.
    whisper encodes its smoke config's 16 frames, or 12, where JAX's cross
    cache takes the frames' length and the port's must too; llava's cache
    holds its 8 patches before the prompt (it has no frames)."""
    lp.prefill_and_decode(arch, prompt, 6, frames=frames)


def test_greedy_sample_loop_matches_jax(arch):
    """`serve.sample_loop` takes the frames or patches through to its
    prefill: 6 greedy tokens after a 9-token prompt, JAX's."""
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    batch = lp.inputs(tcfg, np.random.default_rng(8).integers(
        0, tcfg.vocab, (2, 9)))
    max_len = tcfg.patch_positions + 9 + 6 + 1
    want = jserve.sample_loop(arch["params"], jcfg, lp.jbatch(batch),
                              steps=6, max_len=max_len)
    got = serve.sample_loop(params_from_jax(arch["tree"], tcfg,
                                            device="cpu"), tcfg, batch,
                            steps=6, max_len=max_len, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_cache_matches_jax(arch):
    jcfg, tcfg = lp.cfgs(arch["name"], compute_dtype="bfloat16")
    got = params_from_jax(arch["tree"], tcfg, device="cpu").init_cache(3, 16)
    want = lp.np_tree(jtf.init_cache(jcfg, 3, 16))
    assert set(got) == set(want)
    for j, sub in want.items():
        assert set(got[j]) == set(sub)
        for kind, leaves in sub.items():
            assert set(got[j][kind]) == set(leaves)
            for name, leaf in leaves.items():
                mine = got[j][kind][name]
                assert mine.dtype == (torch.int32 if name == "pos"
                                      else torch.bfloat16), (j, kind, name)
                np.testing.assert_array_equal(mine.float().numpy(), leaf)


def test_flash_branch_matches_attend_on_the_encoder():
    """whisper's encoder self-attention without causality: the forward with
    ``use_flash_kernel=True`` (the wrapper's plain version on the CPU)
    against the port's ``_attend`` path (blockwise at ``attn_block_kv``
    8 over 16 frames) and against JAX's flash kernel in interpret mode,
    within 1e-4 of max |logits|."""
    jcfg, tcfg = lp.cfgs("whisper-tiny", attn_block_kv=8)
    params = lp.jinit(jax.random.PRNGKey(2), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            tcfg, device="cpu")
    batch = lp.inputs(tcfg, np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, 20)))
    flash_t = dataclasses.replace(tcfg, use_flash_kernel=True)
    with torch.no_grad():
        plain, _, _ = model(lp.tbatch(batch))
        flash, _, _ = model(lp.tbatch(batch), flash_t)
        enc_plain = model._encode(tcfg, torch.from_numpy(batch["frames"]))
        enc_flash = model._encode(flash_t, torch.from_numpy(batch["frames"]))
    assert lp.rel(enc_flash.numpy(), enc_plain.numpy()) < 1e-4
    assert lp.rel(flash.numpy(), plain.numpy()) < 1e-4
    want, _, _ = jax.jit(jtf.forward, static_argnums=1)(
        params, dataclasses.replace(jcfg, use_flash_kernel=True),
        lp.jbatch(batch))
    assert lp.rel(flash.numpy(), want) < 1e-4


# -- training --------------------------------------------------------------------


@pytest.mark.parametrize("name,microbatch", [("whisper-tiny", None),
                                             ("whisper-tiny", 2),
                                             ("llava-next-34b", None)])
def test_three_train_steps_match_jax(name, microbatch):
    """3 steps of ``make_train_step`` on batches with frames or patches,
    each from JAX's state of the step before; ``microbatch=2`` splits the
    frames with the tokens, row ``j*2 + m`` to micro-step ``m``."""
    lp.three_train_steps(name, orthogonal=False, tau=1e-6,
                         microbatch=microbatch)


def _equal(a, b):
    """Two trees of arrays, the same keys and the same leaves bit for
    bit."""
    if not isinstance(a, dict):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    assert set(a) == set(b)
    for key in a:
        _equal(a[key], b[key])


def test_checkpoints_carry_the_encoder_both_ways(tmp_path):
    """A whisper-smoke `TrainState` after two steps, saved by the port's
    `CheckpointManager`, restores in JAX's with identical leaves (the
    encoder's stacked over ``encoder_blocks``); JAX's after one step
    restores in the port's."""
    jcfg, tcfg = lp.cfgs("whisper-tiny")
    opt = AdamWConfig(lr=1e-2)
    state = init_state(torch.Generator().manual_seed(12), tcfg, opt,
                       device="cpu")
    step = make_train_step(tcfg, opt, device="cpu")
    for s in range(2):
        step(state, lp.inputs(tcfg, np.random.default_rng(s).integers(
            0, tcfg.vocab, (2, 16)), seed=s))
    CheckpointManager(str(tmp_path / "port")).save(2, state, blocking=True)
    j_opt = jadamw.AdamWConfig(lr=1e-2)
    shape = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        jstep.init_state(jax.random.PRNGKey(0), jcfg, j_opt))
    restored = JCheckpointManager(str(tmp_path / "port")).restore(2, shape)
    params = params_to_numpy(state.model)
    assert params["encoder"]["pos0"]["mixer"]["wq"].shape[0] == \
        tcfg.encoder_blocks
    _equal(jax.tree_util.tree_map(np.asarray, restored.params), params)
    mom = opt_state_to_numpy(state.opt_state, state.model)
    for key in ("mu", "nu", "step"):
        _equal(jax.tree_util.tree_map(np.asarray, restored.opt_state[key]),
               mom[key])

    jstate = jstep.init_state(jax.random.PRNGKey(3), jcfg, j_opt)
    mesh = jmake_host_mesh()
    batch = lp.inputs(tcfg, np.random.default_rng(9).integers(
        0, tcfg.vocab, (2, 16)))
    with mesh:
        jstate, _ = jax.jit(jstep.make_train_step(jcfg, j_opt, mesh))(
            jstate, lp.jbatch(batch))
    JCheckpointManager(str(tmp_path / "jax")).save(1, jstate, blocking=True)
    target = init_state(torch.Generator().manual_seed(0), tcfg,
                        AdamWConfig(), device="cpu")
    got_step, got = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        target)
    assert got_step == 1 and got is target and int(got.step) == 1
    _equal(params_to_numpy(got.model),
           jax.tree_util.tree_map(np.asarray, jstate.params))
    mom = opt_state_to_numpy(got.opt_state, got.model)
    for key in ("mu", "nu", "step"):
        _equal(mom[key], jax.tree_util.tree_map(np.asarray,
                                                jstate.opt_state[key]))


def test_port_init_draws_the_new_leaves():
    """`Transformer.init` fills ``enc_pos`` (N(0, 0.02²)), the encoder,
    ``enc_norm``, the cross-attention and ``patch_proj``: every leaf
    finite, the norms at 1, no weight left at 0."""
    for name in ENC_DEC_ARCHS:
        _, tcfg = lp.cfgs(name)
        model = Transformer(tcfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for pname, p in model.named_parameters():
            p = p.detach()
            assert bool(torch.isfinite(p).all()), pname
            if pname.endswith("scale"):
                assert bool((p == 1).all()), pname
            elif not pname.endswith("bias"):
                assert float(p.abs().max()) > 0, pname
        if tcfg.is_enc_dec:
            assert 0.01 < float(model.enc_pos.std()) < 0.03
