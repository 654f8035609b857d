"""The port's dense LM eval path against the JAX package's, on the CPU.

The same weights (JAX's ``init_params``, loaded with `params_from_jax`) and
the same tokens (numpy, seeded) go through JAX's ``forward`` / ``loss_fn`` /
``make_eval_step`` and the port's. The JAX side runs its flash kernel in
interpret mode where ``use_flash_kernel`` is set. Tolerances, relative to
max |logits|: 1e-4 with float32 compute (the ops agree to rounding), 2e-2
with bfloat16 compute (the two frameworks round bfloat16 at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config as jget_config
from repro.launch.mesh import make_host_mesh
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.train.step import make_eval_step as jmake_eval_step
from repro_torch.configs import get_config
from repro_torch.kernels import _platform
from repro_torch.models import layers, weights
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import params_from_jax
from repro_torch.train import make_eval_step

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(compute_dtype, head_dim=32, **kw):
    """qwen3's SMOKE config in both packages' ModelConfig."""
    over = dict(compute_dtype=compute_dtype, head_dim=head_dim, **kw)
    return (dataclasses.replace(jget_config("qwen3-8b", smoke=True), **over),
            dataclasses.replace(get_config("qwen3-8b", smoke=True), **over))


def _params(jcfg, seed=0):
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


def _tokens(cfg, b=2, t=64, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
def test_forward_and_loss_match_jax(compute_dtype, flash):
    jcfg, tcfg = _cfgs(compute_dtype, use_flash_kernel=flash)
    params, tree = _params(jcfg)
    tokens = _tokens(tcfg)
    jbatch = {"tokens": jnp.asarray(tokens)}
    logits_j, aux_j, off_j = jax.jit(jtf.forward, static_argnums=1)(
        params, jcfg, jbatch)
    loss_j, m_j = jax.jit(jtf.loss_fn, static_argnums=1)(params, jcfg, jbatch)
    model = params_from_jax(tree, tcfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        logits_t, aux_t, off_t = model(batch)
        loss_t, m_t = model.loss_fn(batch)
    assert off_t == off_j == 0 and float(aux_t) == float(aux_j) == 0.0
    assert logits_t.shape == logits_j.shape and logits_t.dtype == torch.float32
    tol = TOL[compute_dtype]
    assert _rel(logits_t.numpy(), logits_j) < tol
    assert abs(float(loss_t) - float(loss_j)) < tol * abs(float(loss_j))
    for key in ("ce", "zloss", "tokens"):
        assert abs(float(m_t[key]) - float(m_j[key])) <= tol * max(
            1.0, abs(float(m_j[key])))


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norms_and_rope_match_jax(norm):
    """The building blocks on their own: both norms (``norm="layer"`` is
    whisper's), the vector RMS norm of qk-norm, and RoPE."""
    rng = np.random.default_rng(9)
    jcfg, tcfg = _cfgs("float32", norm=norm)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, tcfg.d_model).astype(np.float32),
         "bias": rng.normal(size=tcfg.d_model).astype(np.float32)}
    mod = layers.make_norm(tcfg)
    with torch.no_grad():
        for name, param in mod.named_parameters():
            param.copy_(torch.from_numpy(p[name]))
        got = mod(torch.from_numpy(x)).numpy()
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()
                               if k in dict(mod.named_parameters())},
                              jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    q = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    pos = np.arange(3, 8)
    np.testing.assert_allclose(
        layers.rms_norm_vec(torch.from_numpy(q), torch.from_numpy(
            p["scale"][:32])).numpy(),
        np.asarray(jlayers.rms_norm_vec(jnp.asarray(q),
                                        jnp.asarray(p["scale"][:32]))),
        atol=1e-5)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                          1e4).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        atol=1e-5)


@pytest.mark.parametrize("head_dim", [32, 128])
def test_flash_path_matches_attend_path(head_dim):
    """``use_flash_kernel=True`` against the port's own ``_attend`` path on
    one set of weights (mirrors tests/test_flash_kernel.py:66), long enough
    for the blockwise branch."""
    _, tcfg = _cfgs("float32", head_dim=head_dim, attn_block_kv=32,
                    param_dtype="float32")
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, t=96))}
    with torch.no_grad():
        l1, _, _ = model(batch)
        l2, _, _ = model(batch, dataclasses.replace(tcfg,
                                                    use_flash_kernel=True))
    assert float((l1 - l2).abs().max()) < 1e-3 * float(l1.abs().max())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_config_builds_with_jax_shapes(name):
    """Every config builds, its parameters' shapes JAX's leaf for leaf: the
    dense-attention, MoE and state-space layers, whisper-tiny's encoder
    (stacked over ``encoder_blocks``), ``enc_pos``, ``enc_norm`` and
    cross-attention, and llava-next-34b's ``patch_proj``."""
    cfg = get_config(name, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config(name, smoke=True))
    model = Transformer(cfg, device="cpu")
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, jget_config(
        name, smoke=True)), jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {"/".join(weights.jax_path(n)): tuple(p.shape)
           if weights.block_index(n) is None
           else (weights.stack_depth(cfg, n),) + tuple(p.shape)
           for n, p in model.named_parameters()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


def test_full_configs_match_jax():
    for name in ARCH_NAMES:
        assert get_config(name).param_count() == \
            jget_config(name).param_count()


def test_eval_step_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16", head_dim=128, use_flash_kernel=True)
    params, tree = _params(jcfg, seed=3)
    tokens = _tokens(tcfg, t=128, seed=4)
    mesh = make_host_mesh()
    with mesh:
        m_j = jax.jit(jmake_eval_step(jcfg, mesh))(
            params, {"tokens": jnp.asarray(tokens)})
    model = params_from_jax(tree, tcfg, device="cpu")
    _platform.reset_launch_counts()
    m_t = make_eval_step(tcfg, device="cpu")(model, {"tokens": tokens})
    assert _platform.launch_counts().get("flash_attention", 0) == 0  # CPU
    assert set(m_t) == set(m_j)
    for key in m_j:
        assert m_t[key].device.type == "cpu"
        assert abs(float(m_t[key]) - float(m_j[key])) <= 2e-2 * max(
            1.0, abs(float(m_j[key]))), key


def test_params_from_jax_refuses_a_mismatched_tree():
    jcfg, tcfg = _cfgs("float32")
    _, tree = _params(jcfg)
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(tree, tcfg, device="cpu")


def test_forward_refuses_a_config_of_another_shape():
    _, tcfg = _cfgs("float32")
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    other = dataclasses.replace(tcfg, d_ff=2 * tcfg.d_ff)
    with pytest.raises(ValueError, match="d_ff"):
        model({"tokens": torch.zeros(1, 4, dtype=torch.long)}, other)


def test_attention_cache_and_cross_branches_are_ported():
    """The cross branch (A14.5) attends over ``kv_x``, or over the K/V of
    a cache it returns unwritten (`tests/test_torch_enc_dec.py` holds it to
    JAX). The cache branch (A14.1): a prefill fills the cache it is given,
    in place, and returns it (`tests/test_torch_decode.py` holds it to
    JAX)."""
    _, tcfg = _cfgs("float32")
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(2))
    attn = model.blocks[0][0].mixer
    x = torch.randn(1, 4, tcfg.d_model, generator=torch.Generator(
        ).manual_seed(3))
    enc = torch.randn(1, 6, tcfg.d_model, generator=torch.Generator(
        ).manual_seed(4))
    with torch.no_grad():
        y, none = attn(x, tcfg, cross=True, kv_x=enc)
        k, v = attn.cross_kv(enc, tcfg)
        assert tcfg.qk_norm  # which norms the projected K, not a cached one
        kv = {"k": layers.rms_norm_vec(k, attn.k_norm), "v": v}
        before = {name: t.clone() for name, t in kv.items()}
        y_cached, same = attn(x, tcfg, cross=True, cache=kv)
    assert none is None and same is kv and y.shape == x.shape
    assert all(torch.equal(kv[name], before[name]) for name in kv)
    assert torch.allclose(y, y_cached, atol=1e-6)
    cache = layers.init_attn_cache(tcfg, 1, 8, torch.float32)
    with torch.no_grad():
        y, out = attn(x, tcfg, cache=cache,
                      cache_pos=torch.zeros((), dtype=torch.int32))
    assert out is cache and y.shape == x.shape
    assert cache["pos"].tolist() == [0, 1, 2, 3, -1, -1, -1, -1]


def test_eval_step_defaults_to_the_card():
    _, tcfg = _cfgs("float32")
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(tcfg)


def test_model_defaults_to_the_card():
    jcfg, tcfg = _cfgs("float32")
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(tcfg)
    _, tree = _params(jcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree, tcfg)
