"""The port's LM serving (prefill, decode, the KV cache, the sampler) against
the JAX package's, on the CPU.

The same weights (JAX's ``init_params``, loaded with `params_from_jax`) and
the same tokens (numpy, seeded) go through JAX's ``prefill`` /
``decode_step`` / ``sample_loop`` and the port's. Prefill's logits, every
decode step's logits and every cache leaf (``k``, ``v``, ``pos`` of each
sub-layer, and the top-level ``pos``) are compared, relative to the largest
magnitude of the JAX value: 1e-4 with float32 compute, 2e-2 with bfloat16
(`tests/test_torch_lm.py`'s ``TOL``); positions exactly. The port's own
decode-vs-forward bound is the JAX package's, 2e-3 × max(max |logits|, 1)
(`tests/test_decode_consistency.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.train import serve as jserve
from repro_torch.configs import get_config
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.train import serve

DENSE_ATTN = ("minicpm-2b", "command-r-35b", "granite-3-8b", "qwen3-8b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

_jprefill = jax.jit(jtf.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jtf.decode_step, static_argnums=1)


def _cfgs(name, compute_dtype="float32", **kw):
    over = dict(compute_dtype=compute_dtype, **kw)
    return (dataclasses.replace(jget_config(name, smoke=True), **over),
            dataclasses.replace(get_config(name, smoke=True), **over))


def _setup(name, compute_dtype="float32", seed=0, **kw):
    """Both configs, JAX's parameters and the port's model holding them."""
    jcfg, tcfg = _cfgs(name, compute_dtype, **kw)
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _tokens(cfg, b=2, t=20, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def _np(tree):
    """A JAX tree as numpy, bfloat16 widened to float32."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32)
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a), tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _check_cache(got, want, tol):
    """Every leaf of the port's cache against JAX's."""
    got, want = cache_to_numpy(got), _np(want)
    assert set(got["blocks"]) == set(want["blocks"])
    for j, sub in want["blocks"].items():
        for name, leaf in sub["attn"].items():
            mine = got["blocks"][j]["attn"][name]
            assert mine.shape == leaf.shape, (j, name)
            if name == "pos":
                np.testing.assert_array_equal(mine, leaf)
            else:
                assert _rel(mine, leaf) < tol, (j, name)
    assert int(got["pos"]) == int(want["pos"])


def _serve_both(jcfg, params, model, tokens, prompt, max_len, tol,
                port_cache=None):
    """Prefill ``tokens[:, :prompt]`` and decode the rest teacher-forced in
    both packages, comparing logits and caches after every call. With
    ``port_cache`` the port decodes from it instead of its own prefill."""
    lj, cj = _jprefill(params, jcfg, {"tokens": jnp.asarray(
        tokens[:, :prompt])}, max_len)
    if port_cache is None:
        lt, ct = model.prefill({"tokens": torch.from_numpy(
            tokens[:, :prompt])}, max_len)
        assert lt.shape == lj.shape and lt.dtype == torch.float32
        assert _rel(lt.numpy(), lj) < tol
    else:
        ct = port_cache(cj)
    _check_cache(ct, cj, tol)
    for j in range(prompt, tokens.shape[1]):
        tok = tokens[:, j:j + 1]
        lj, cj = _jdecode(params, jcfg, cj, jnp.asarray(tok, jnp.int32))
        lt, ct2 = model.decode_step(ct, torch.from_numpy(tok))
        assert ct2 is ct  # written in place
        assert _rel(lt.numpy(), lj) < tol, j
        _check_cache(ct, cj, tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE_ATTN)
def test_prefill_and_decode_match_jax(name, compute_dtype):
    jcfg, tcfg, params, model = _setup(name, compute_dtype)
    _serve_both(jcfg, params, model, _tokens(tcfg), 17, 24,
                TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_blockwise_prefill_and_decode_match_jax(compute_dtype):
    """``attn_block_kv=8``: the 17-token prompt and the 24-slot cache are
    both longer, so prefill and decode both take ``_sdpa_blockwise``."""
    jcfg, tcfg, params, model = _setup("qwen3-8b", compute_dtype,
                                       attn_block_kv=8)
    _serve_both(jcfg, params, model, _tokens(tcfg), 17, 24,
                TOL[compute_dtype])


@pytest.mark.parametrize("prompt", [17, 5])
def test_ring_buffer_matches_jax(prompt):
    """``swa_window=8`` (8 slots): a 17-token prompt keeps its last 8 rows
    rolled by 17 % 8; a 5-token prompt fills slots 0–4, then decoding wraps
    the ring."""
    jcfg, tcfg, params, model = _setup("granite-3-8b", swa_window=8)
    _serve_both(jcfg, params, model, _tokens(tcfg, t=prompt + 7), prompt,
                32, TOL["float32"])


@pytest.mark.parametrize("prompt", [5, 9])
def test_linear_cache_past_max_len_matches_jax(prompt):
    """A linear cache of 7 slots decoded past position 6: JAX clamps the
    write to the last slot, and so does the port (on the device). A 9-token
    prompt does not fit: prefill keeps its last 7 rows rolled by 9 % 7."""
    jcfg, tcfg, params, model = _setup("qwen3-8b")
    _serve_both(jcfg, params, model, _tokens(tcfg, t=prompt + 4), prompt, 7,
                TOL["float32"])


def test_decode_from_a_jax_cache_matches_jax():
    """The port decodes from `cache_from_jax` of JAX's prefill cache, made
    outside any inference mode."""
    jcfg, tcfg, params, model = _setup("granite-3-8b", "bfloat16")
    _serve_both(jcfg, params, model, _tokens(tcfg), 17, 24,
                TOL["bfloat16"],
                port_cache=lambda cj: cache_from_jax(_np(cj), tcfg,
                                                     device="cpu"))


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs("qwen3-8b", "bfloat16", swa_window=8)
    model = Transformer(tcfg, device="cpu")
    got = model.init_cache(3, 32)
    want = _np(jtf.init_cache(jcfg, 3, 32))
    attn, jattn = got["pos0"]["attn"], want["pos0"]["attn"]
    assert set(got) == set(want) and set(attn) == set(jattn)
    assert attn["k"].dtype == torch.bfloat16 and \
        attn["pos"].dtype == torch.int32
    for name in jattn:
        np.testing.assert_array_equal(attn[name].float().numpy(),
                                      jattn[name])


def test_cache_from_jax_refuses_a_mismatched_tree():
    jcfg, tcfg, params, _ = _setup("qwen3-8b")
    _, cj = _jprefill(params, jcfg, {"tokens": jnp.zeros((1, 4), jnp.int32)},
                      8)
    other = dataclasses.replace(tcfg, n_blocks=tcfg.n_blocks + 1)
    with pytest.raises(ValueError, match="super-blocks"):
        cache_from_jax(_np(cj), other, device="cpu")


@pytest.mark.parametrize("name", DENSE_ATTN)
def test_decode_matches_forward(name):
    """The port alone: prefill + teacher-forced decode against the train
    forward's logits (the counterpart of JAX's test)."""
    _, tcfg = _cfgs(name, param_dtype="float32")
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    s, extra = 17, 3
    toks = torch.from_numpy(_tokens(tcfg, t=s + extra))
    with torch.inference_mode():
        full, _, off = model({"tokens": toks})
    lg, cache = model.prefill({"tokens": toks[:, :s]}, s + extra)
    errs = [float((lg - full[:, off + s - 1]).abs().max())]
    for j in range(extra):
        lg, cache = model.decode_step(cache, toks[:, s + j][:, None])
        errs.append(float((lg - full[:, off + s + j]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 2e-3 * max(scale, 1.0), (name, errs)


def test_cache_position_advances():
    _, tcfg = _cfgs("granite-3-8b")
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    prefill = serve.make_prefill(tcfg, 16, device="cpu")
    decode = serve.make_decode_step(tcfg, device="cpu")
    _, cache = prefill(model, {"tokens": _tokens(tcfg, b=1, t=5)})
    assert cache["pos"].dtype == torch.int32 and cache["pos"].ndim == 0
    assert int(cache["pos"]) == 5
    _, cache = decode(model, cache, np.zeros((1, 1), np.int64))
    assert int(cache["pos"]) == 6
    _, cache = model.decode_step(cache, torch.zeros(1, 1, dtype=torch.long))
    assert int(cache["pos"]) == 7


@pytest.mark.parametrize("name", ["qwen3-8b", "minicpm-2b"])
def test_greedy_sample_loop_matches_jax(name):
    jcfg, tcfg, params, model = _setup(name)
    tokens = _tokens(tcfg, t=9)
    steps, max_len = 6, 9 + 6 + 1
    want = jserve.sample_loop(params, jcfg, {"tokens": jnp.asarray(tokens)},
                              steps=steps, max_len=max_len)
    got = serve.sample_loop(model, tcfg, {"tokens": tokens}, steps=steps,
                            max_len=max_len, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_is_repeatable_and_in_vocab():
    """vocab 300 of 384 padded rows: the padding is never drawn."""
    _, tcfg = _cfgs("minicpm-2b", vocab=300)
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {"tokens": _tokens(tcfg, b=3, t=6)}

    def run(seed):
        return serve.sample_loop(model, tcfg, batch, steps=8, max_len=16,
                                 temperature=0.8, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))

    a, b, c = run(4), run(4), run(5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 8)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab


def test_unported_parts_raise_naming_their_items(tmp_path):
    """A14.6 ported the cache specs, the meshes with a model axis and
    training over a mesh: the cache specs are a table, the production mesh
    refuses a world that is not 256 or 512 ranks, a model axis that does
    not divide the world is refused, and the serving mesh is not a
    training mesh. A14.7 split the compute over ``model`` for the eval
    forward and training. A14.8 ported sharded prefill and decode: the dry
    run's serving cells build their programs (2·N·B·S and 2·N·B model
    FLOPs), and `Transformer.prefill` and ``decode_step`` run on a model
    whose layers are bound to a model axis of two ranks, inside a world of
    two gloo ranks (`tests/_torch_serve_mesh_driver.py`), giving the
    mesh-less logits; a model split over a model axis without a placement
    is refused."""
    import os
    import pathlib
    import subprocess
    import sys

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import input_specs
    from repro_torch.launch.mesh import (DataMesh, make_host_mesh,
                                         make_production_mesh)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = get_config("qwen3-8b", smoke=True)
    cache = {"blocks": Transformer(cfg, device="cpu").init_cache(2, 8),
             "pos": torch.zeros((), dtype=torch.int32)}
    specs = serve.cache_specs(cfg, {"data": 2, "model": 1}, cache)
    assert tuple(specs["blocks"]["pos0"]["attn"]["k"]) == \
        (None, "data", None, "model", None)
    assert tuple(specs["pos"]) == ()
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="model=2"):
        make_host_mesh(model=2, device="cpu")
    two = DataMesh(group=None, size=2, rank=0, device=torch.device("cpu"),
                   ranks=(0, 1), backend="gloo")
    with pytest.raises(TypeError, match="AxisMesh"):
        make_train_step(cfg, AdamWConfig(), two)
    for shape in ("prefill_32k", "decode_32k"):
        spec = SHAPES[shape]
        with FakeTensorMode():
            fn, args, flops = input_specs(cfg, shape,
                                          make_host_mesh(device="cpu"))
        n = 2.0 * cfg.active_param_count() * spec.global_batch
        assert flops == n * (spec.seq_len if spec.kind == "prefill" else 1)
        assert callable(fn) and len(args) == (2 if shape == "prefill_32k"
                                              else 3)
    from repro_torch.sharding.collectives import ModelAxis

    split = Transformer(cfg, device="cpu")
    split.tp = ModelAxis(size=2)  # as `Placement.shard` sets it at model 2
    with pytest.raises(ValueError, match="without a placement"):
        split.prefill({"tokens": torch.zeros((1, 4), dtype=torch.int64)}, 8)

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(repo / "tests" / "_torch_serve_mesh_driver.py"),
         str(r), "2", "2", "0", str(tmp_path / "store"), "axis",
         str(tmp_path / "out.npz")], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    one = dataclasses.replace(cfg, compute_dtype="float32")
    model = Transformer(one, device="cpu").init(
        torch.Generator().manual_seed(5))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, one.vocab, (1, 8)))
    logits, c = model.prefill({"tokens": tokens}, 16)
    step, _ = model.decode_step(c, tokens[:, :1])
    with np.load(tmp_path / "out.npz") as f:
        assert int(f["size"]) == 2
        assert _rel(f["prefill"], logits.numpy()) < 1e-5
        assert _rel(f["decode"], step.numpy()) < 1e-5


def test_serving_defaults_to_the_card():
    _, tcfg = _cfgs("qwen3-8b")
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_prefill(tcfg, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_decode_step(tcfg)
    model = Transformer(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.sample_loop(model, tcfg, {"tokens": _tokens(tcfg)}, steps=2,
                          max_len=24)
