"""The port's sharding rules, cache specs, meshes and placements against the
JAX package's, on the CPU.

`param_specs` is held to JAX's ``param_specs`` leaf by leaf for all ten
archs at full size, on the production meshes (``make_abstract_mesh``
(16, 16) and (2, 16, 16), as ``tests/test_sharding.py`` builds them) and
on host shapes (2, 1), (1, 2), (2, 2): the port's shapes come from a
`Transformer` built under ``FakeTensorMode`` (nothing allocated), JAX's
from ``jax.eval_shape`` of ``init_params``; a super-block's spec is JAX's
stacked leaf's without its leading ``None``. `cache_specs` is held to
JAX's for every leaf of both packages' ``init_cache`` at ``decode_32k``'s
and ``long_500k``'s shapes, ``shard_seq`` and ``kv_seq_over_model`` both
ways. `batch_specs` and `data_axes` are equal to JAX's. Exact equality
throughout: the specs are data.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.compat import AxisType, make_abstract_mesh
from repro.configs import ARCH_NAMES, get_config as jget_config
from repro.models import transformer as jtf
from repro.sharding import rules as jrules
from repro.train import serve as jserve
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (AxisMesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import block_index, jax_path
from repro_torch.sharding import rules
from repro_torch.sharding.collectives import recording
from repro_torch.sharding.placement import Placement
from repro_torch.train.serve import cache_specs

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _jmesh(key):
    shape, axes = MESHES[key]
    return make_abstract_mesh(shape, axes,
                              axis_types=(AxisType.Auto,) * len(axes))


def _shape(key) -> dict:
    shape, axes = MESHES[key]
    return dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def _jshapes(name):
    cfg = jget_config(name)
    return jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _tshapes(name) -> dict:
    with FakeTensorMode():
        model = Transformer(get_config(name), device="cpu")
        return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_equal_jax(name, mesh):
    jspecs = jrules.param_specs(jget_config(name), _jmesh(mesh),
                                _jshapes(name))
    tshapes = _tshapes(name)
    specs = rules.param_specs(get_config(name), _shape(mesh), tshapes)
    assert set(specs) == set(tshapes)
    for n, spec in specs.items():
        assert isinstance(spec, rules.PartitionSpec)
        want = tuple(_leaf(jspecs, jax_path(n)))
        if block_index(n) is not None:
            assert want[0] is None, (n, want)
            want = want[1:]
        assert tuple(spec) == want, (name, mesh, n, spec, want)
    # every JAX leaf is some parameter's
    jleaves = len(jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert jleaves == len({jax_path(n) for n in specs})


@functools.lru_cache(maxsize=None)
def _caches(name, batch, max_len):
    jcfg, tcfg = jget_config(name), get_config(name)
    jcache = jax.eval_shape(lambda: {
        "blocks": jtf.init_cache(jcfg, batch, max_len),
        "pos": jnp.zeros((), jnp.int32)})
    with FakeTensorMode():
        model = Transformer(tcfg, device="cpu")
        blocks = model.init_cache(batch, max_len)
        tcache = {"blocks": blocks, "pos": torch.zeros((), dtype=torch.int32)}
    return jcache, tcache


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_equal_jax(name, mesh):
    """Every cache leaf at decode_32k's (128 × 32,768) and long_500k's
    (1 × 524,288) shapes, ``shard_seq`` and ``kv_seq_over_model`` both
    ways."""
    for batch, max_len in ((128, 32_768), (1, 524_288)):
        jcache, tcache = _caches(name, batch, max_len)
        for shard_seq in (False, True):
            for kv_seq in (False, True):
                fn = jserve.cache_specs(jget_config(name), _jmesh(mesh),
                                        shard_seq=shard_seq,
                                        kv_seq_over_model=kv_seq)
                jspecs = jax.tree_util.tree_map_with_path(fn, jcache)
                tspecs = cache_specs(get_config(name), _shape(mesh), tcache,
                                     shard_seq=shard_seq,
                                     kv_seq_over_model=kv_seq)
                got = dict(_flat(tspecs))
                want = {tuple(getattr(p, "key", p) for p in path): spec
                        for path, spec in jax.tree_util.tree_flatten_with_path(
                            jspecs, is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))[0]}
                assert set(got) == set(want)
                for key, spec in got.items():
                    assert tuple(spec) == tuple(want[key]), \
                        (name, mesh, batch, shard_seq, kv_seq, key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_and_data_axes_equal_jax(mesh):
    cfg, jcfg = get_config("qwen3-8b"), jget_config("qwen3-8b")
    assert rules.data_axes(_shape(mesh)) == jrules.data_axes(_jmesh(mesh))
    for shard_seq in (False, True):
        got = rules.batch_specs(cfg, _shape(mesh), shard_seq=shard_seq)
        want = jrules.batch_specs(jcfg, _jmesh(mesh), shard_seq=shard_seq)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def test_param_shardings_cover_every_element_once():
    """Over a (2, 3) mesh with FSDP (qwen3 smoke's 4 heads do not divide
    3: the row-parallel fallback splits d_model over ``("model",
    "data")``), the six ranks' slices cover every tensor: each element once
    for each rank that holds it, the ranks of an axis the spec does not
    name holding the same slice."""
    import dataclasses
    import math

    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), fsdp=True)
    shape = {"data": 2, "model": 3}
    model = _smoke_shapes("qwen3-8b", fsdp=True)
    specs = rules.param_specs(cfg, shape, model)
    assert specs["blocks.0.0.mixer.wq"] == rules.P(("model", "data"), None,
                                                    None)
    for name, dims in model.items():
        held = torch.zeros(dims, dtype=torch.int64)
        named = {a for e in specs[name] for a in rules.spec_axes(e)}
        for d in range(2):
            for m in range(3):
                sl = rules.param_shardings(cfg, shape, model,
                                           {"data": d, "model": m})[name]
                held[sl] += 1
        copies = 6 // math.prod(shape[a] for a in named)
        assert bool((held == copies).all()), (name, specs[name])


def _smoke_shapes(arch, **over):
    import dataclasses

    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    with FakeTensorMode():
        return {n: tuple(p.shape) for n, p in
                Transformer(cfg, device="cpu").named_parameters()}


def test_a_tuple_entry_is_model_major():
    shape = {"data": 2, "model": 3}
    got = [rules.shard_bounds(13, ("model", "data"), shape,
                              {"data": d, "model": m})
           for m in range(3) for d in range(2)]
    assert [g[:2] for g in got] == [(0, 3), (3, 6), (6, 9), (9, 12),
                                    (12, 13), (13, 13)]
    assert {g[2] for g in got} == {3}


def test_meshes_without_a_process_group():
    one = make_host_mesh(device="cpu")
    assert isinstance(one, AxisMesh)
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert one.coords == {"data": 0, "model": 0} and one.group("data") is None
    with pytest.raises(ValueError, match="model=2.*world of 1"):
        make_host_mesh(model=2, device="cpu")
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"{need} ranks.*has 1"):
            make_production_mesh(multi_pod=multi)
    mesh = AxisMesh(("pod", "data", "model"), (2, 16, 16), 300,
                    torch.device("cpu"), "fake")
    assert mesh.coords == {"pod": 1, "data": 2, "model": 12}
    assert rules.data_axes(mesh) == ("pod", "data")


def test_a_one_rank_placement_keeps_the_model_as_it_is():
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config("qwen3-8b", smoke=True)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    before = {n: p for n, p in model.named_parameters()}
    opt = adamw_init(model, AdamWConfig())
    mu = dict(opt["mu"])
    place = Placement(cfg, make_host_mesh(device="cpu"), model)
    place.shard(model, opt)
    assert all(place.whole(n) for n in before)
    assert all(p is before[n] for n, p in model.named_parameters())
    assert all(opt["mu"][n] is t for n, t in mu.items())
    with recording() as record, place.bind(model):
        assert model.block_runner == place.run_block
        assert all(torch.equal(p, before[n])
                   for n, p in model.named_parameters())
        model.loss_fn({"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                      cfg)[0].backward()
    assert record == [] and model.block_runner is None
    assert all(p is before[n] and p.grad is not None
               for n, p in model.named_parameters())
