"""The port's optimizer (`repro_torch.optim`) against the JAX package's, on
the CPU.

The same inputs, drawn with numpy from a seed, go through JAX's schedules,
AdamW, orthogonal update and int8 compression and through the port's. JAX
runs as its own tests run it (x64 on, CPU). Tolerances: 1e-6 for the
schedules and for AdamW (both compute in float32; they differ only in the
order of a few sums), 1e-5 of max |x| for the orthogonal update (TSQR and a
triangular solve in float32), and equality up to float32 rounding for the
int8 compression (the same quantization).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import orthogonal as jorthogonal
from repro.optim import schedules as jschedules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.weights import (opt_state_from_jax,
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compressed_psum, global_norm, init_residual,
                               orthogonalize, orthogonalized_update,
                               warmup_cosine, wsd)


def _tree_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _assert_trees_close(got, want, rtol, atol):
    got, want = dict(_tree_items(got)), dict(_tree_items(want))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("kind", ["cosine", "cosine-long-warmup", "wsd"])
def test_schedules_match_jax(kind):
    if kind == "cosine":
        args = (3e-3, 10, 110), {}
        ours, theirs = warmup_cosine, jschedules.warmup_cosine
    elif kind == "cosine-long-warmup":
        args = (1.0, 40, 100), {"floor": 0.05}
        ours, theirs = warmup_cosine, jschedules.warmup_cosine
    else:
        args = (1e-2, 10, 50, 40), {"floor": 0.01}
        ours, theirs = wsd, jschedules.wsd
    fo, fj = ours(*args[0], **args[1]), theirs(*args[0], **args[1])
    for step in range(121):
        got = fo(torch.tensor(step, dtype=torch.int32))
        want = fj(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert np.asarray(want).dtype == np.float32
        assert abs(float(got) - float(want)) <= 1e-6 * max(
            1e-3, abs(float(want))), step
        assert float(fo(step)) == float(got)  # a plain int works too


def _small_tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "k": rng.normal(size=(2, 3, 5)).astype(np.float32)}


@pytest.mark.parametrize("case", ["plain", "clipped", "bf16-state"])
def test_adamw_update_matches_jax(case):
    rng = np.random.default_rng(3)
    params = _small_tree(rng)
    over = {"plain": dict(clip_norm=1e9),
            "clipped": dict(clip_norm=0.5),
            "bf16-state": dict(state_dtype="bfloat16")}[case]
    kw = dict(lr=jschedules.warmup_cosine(1e-2, 2, 10), weight_decay=0.1,
              **over)
    jcfg = jadamw.AdamWConfig(**kw)
    tcfg = AdamWConfig(**dict(kw, lr=warmup_cosine(1e-2, 2, 10)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jadamw.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adamw_init(tp, tcfg)
    assert tst["mu"]["w"].dtype == (torch.bfloat16 if case == "bf16-state"
                                    else torch.float32)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, jst, jm = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jst, jp, jcfg)
        out_p, out_st, tm = adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, tst, tp,
            tcfg)
        assert out_p is tp and out_st is tst  # updated in place
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-6 * abs(
                float(jm[key])), key
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            for m in ("mu", "nu"):
                np.testing.assert_allclose(
                    tst[m][k].float().numpy(),
                    np.asarray(jst[m][k], np.float32), rtol=1e-6,
                    atol=1e-7 if case != "bf16-state" else 0, err_msg=m + k)
    assert int(tst["step"]) == int(jst["step"]) == 3


def test_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    tree = _small_tree(rng)
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jadamw.global_norm(tree)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


def _qwen_cfgs(**kw):
    jcfg = dataclasses.replace(jget_config("qwen3-8b", smoke=True), **kw)
    return jcfg, dataclasses.replace(get_config("qwen3-8b", smoke=True), **kw)


def _grads_like(tree, rng, scale=1.0):
    return jax.tree_util.tree_map(
        lambda x: (scale * rng.normal(size=np.shape(x))).astype(np.float32),
        tree)


def _named(tree, model):
    """JAX's stacked ``tree`` as the port's per-parameter tensors."""
    holder = params_from_jax(tree, model.cfg, device="cpu")
    return {n: p.detach().clone() for n, p in holder.named_parameters()}


def test_adamw_step_over_the_model_decays_as_jax_stacks():
    """One AdamW step over the qwen3 smoke model's parameters, weight decay
    0.1: JAX decays every stacked leaf of rank ≥ 2 — the block norm scales
    ([n_blocks, d]) and qk-norm scales among them — and not final_norm."""
    jcfg, tcfg = _qwen_cfgs()
    params = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    grads = _grads_like(params, rng, 1e-3)
    ocfg = dict(lr=0.05, weight_decay=0.1, clip_norm=1e9)
    jcfg_o = jadamw.AdamWConfig(**ocfg)
    jp, jst, _ = jax.jit(jadamw.adamw_update, static_argnums=3)(
        grads, jadamw.adamw_init(params, jcfg_o), params, jcfg_o)
    model = params_from_jax(params, tcfg, device="cpu")
    st = adamw_init(model, AdamWConfig(**ocfg))
    adamw_update(_named(grads, model), st, model, AdamWConfig(**ocfg))
    got = params_to_numpy(model)
    _assert_trees_close(got, jax.tree_util.tree_map(np.asarray, jp),
                        rtol=1e-6, atol=1e-6)
    _assert_trees_close(opt_state_to_numpy(st, model)["mu"], jst["mu"],
                        rtol=1e-6, atol=1e-9)
    # The same step by the port's own ranks (a dict of tensors: the plain
    # ndim >= 2 rule) leaves the 1-D block scales undecayed, lr·wd = 5e-3
    # away from JAX's: the comparison above would see it.
    plain = _named(params, model)
    adamw_update(_named(grads, model), adamw_init(plain, AdamWConfig(**ocfg)),
                 plain, AdamWConfig(**ocfg))
    want = np.asarray(jp["blocks"]["pos0"]["norm1"]["scale"][0])
    assert np.abs(plain["blocks.0.0.norm1.scale"].numpy() - want).max() > 4e-3
    np.testing.assert_allclose(plain["final_norm.scale"].numpy(),
                               np.asarray(jp["final_norm"]["scale"]),
                               rtol=1e-6, atol=1e-6)


def test_opt_state_round_trips_through_jax_layout():
    jcfg, tcfg = _qwen_cfgs()
    params = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(6)
    tree = {"mu": _grads_like(params, rng), "nu": _grads_like(params, rng),
            "step": np.asarray(7, np.int32)}
    model = params_from_jax(params, tcfg, device="cpu")
    st = opt_state_from_jax(tree, model)
    assert set(st["mu"]) == {n for n, _ in model.named_parameters()}
    back = opt_state_to_numpy(st, model)
    _assert_trees_close(back, tree, rtol=0, atol=0)
    _assert_trees_close(params_to_numpy(model), params, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(64, 16), (16, 64)])
def test_orthogonalize_matches_jax(shape):
    g = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jorthogonal.orthogonalize)(g))
    got = orthogonalize(torch.from_numpy(g)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    q = got if shape[0] >= shape[1] else got.T
    np.testing.assert_allclose(q.T @ q / q.shape[1], np.eye(q.shape[1]),
                               atol=5e-3)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_orthogonalized_update_matches_jax_leaf_by_leaf(n_blocks):
    """The qwen3 smoke gradients judged as JAX's stacked leaves: MLP weights
    block by block, attention weights left, block norm scales as one matrix
    across the blocks at n_blocks 2 (left at 1), embed and lm_head
    orthogonalized, final_norm left."""
    jcfg, tcfg = _qwen_cfgs(n_blocks=n_blocks)
    params = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(2), jcfg))
    grads = _grads_like(params, np.random.default_rng(8))
    want = jax.tree_util.tree_map(
        np.asarray, jax.jit(jorthogonal.orthogonalized_update)(grads))
    model = params_from_jax(params, tcfg, device="cpu")
    named = _named(grads, model)
    got = orthogonalized_update(named, model=model)
    assert list(got) == list(named)
    holder = params_from_jax(params, tcfg, device="cpu")
    with torch.no_grad():
        for n, p in holder.named_parameters():
            p.copy_(got[n])
    got_tree = params_to_numpy(holder)
    for key, w in _tree_items(want):
        g = dict(_tree_items(got_tree))[key]
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=key)
    blocks = dict(_tree_items(grads))
    moved = {k for k, w in _tree_items(want)
             if not np.array_equal(w, blocks[k])}
    norms = {f"blocks/pos0/{k}" for k in ("norm1/scale", "norm2/scale",
                                          "mixer/q_norm", "mixer/k_norm")}
    assert {"embed", "lm_head", "blocks/pos0/mlp/w_up"} <= moved
    assert not moved & {"final_norm/scale", "blocks/pos0/mixer/wq"}
    assert (norms <= moved) if n_blocks == 2 else not (norms & moved)


def test_orthogonalized_update_of_plain_tensors_keeps_each_rank():
    rng = np.random.default_rng(9)
    tree = {"m": rng.normal(size=(32, 8)).astype(np.float32),
            "s": rng.normal(size=(3, 16, 8)).astype(np.float32),
            "v": rng.normal(size=(8,)).astype(np.float32)}
    want = jax.jit(jorthogonal.orthogonalized_update)(tree)
    got = orthogonalized_update({k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_compressed_psum_at_one_rank_matches_jax():
    """JAX's shard_map case (tests/test_train.py:115) on a one-device mesh,
    against the port's one-rank mesh: the same int8 quantization, and no
    collective on either side."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(10)
    g = {"w": rng.normal(size=(8, 8)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jr = jcompression.init_residual(jg)
    jmesh = jmake_host_mesh()
    out_j, res_j = shard_map(
        lambda gg, rr: jcompression.compressed_psum(gg, rr, "data"),
        mesh=jmesh, in_specs=(P(), P()), out_specs=(P(), P()))(jg, jr)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tr = init_residual(tg)
    mesh = make_host_mesh(device="cpu")
    assert mesh.size == 1
    out_t, res_t = compressed_psum(tg, tr, mesh)
    for k in g:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res_t[k].numpy(), np.asarray(res_j[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out_t[k].numpy() + res_t[k].numpy(),
                                   g[k], atol=1e-6)
    # the residual feeds back: a second step quantizes g + residual
    out2, _ = compressed_psum(tg, res_t, mesh)
    out2_j, _ = shard_map(
        lambda gg, rr: jcompression.compressed_psum(gg, rr, "data"),
        mesh=jmesh, in_specs=(P(), P()), out_specs=(P(), P()))(jg, res_j)
    for k in g:
        np.testing.assert_allclose(out2[k].numpy(), np.asarray(out2_j[k]),
                                   rtol=1e-6, atol=1e-7)
