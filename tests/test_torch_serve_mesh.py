"""The port's sharded prefill and decode over gloo ranks against the JAX
package's one-device ``prefill`` and ``decode_step``, on the CPU.

Three worlds, spawned once and side by side
(`tests/_torch_serve_mesh_driver.py`, one process per rank): 4 ranks as
the (2, 2) ``("data", "model")`` mesh and 2 as (1, 2), each serving a
global batch of two sequences (a row a data rank at (2, 2)), and 4 as
(4, 1) under ``shard_seq`` serving one sequence whose KV slots lie over
the data ranks (context parallelism, long_500k's layout); the (2, 2) world
also serves that one sequence under ``shard_seq``, its slots over ``data``
and, where the kv heads do not divide ``model``, over ``("data",
"model")``, the combine over both. Every case of
the driver module's ``CASES`` — the ten archs' smoke configs (tied embeddings,
patches, frames and the cross cache, mamba, MoE, RWKV's ``shift``,
mixtral's sliding-window ring, which the 12-token prompt runs past), one
kv head (at model 2 the slots over ``model``, the online softmax combined
over them), one head (row-parallel), whisper with three heads (row-parallel,
its self and cross slots over ``model``) and one kv head with
``kv_seq_over_model`` off (the head dim over ``model``) — is prefilled into
a cache of 32 positions and decoded for four steps of given tokens, from
the port's init of the case's config (both packages load the same
parameters, `models.weights`). Held to JAX's jitted one-device calls on
the same global batch (the one sequence is the first of the two; it is
JAX's batch of two's first row but where a MoE layer routes): the
prefill's and every step's logits within 1e-5 of their max |value|, the
cache gathered to JAX's layout after the prefill and after the last step
within 1e-5 of each leaf's max |value| (positions exactly), all in float32
compute. A decode step at (2, 2) issues only the collectives its layout
implies: no all-gather of a K or V leaf.

A one-rank mesh runs the same code with nothing to exchange, and its
prefill and decode are the mesh-less ones bit for bit.
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_mesh_driver as driver
from _torch_train_mesh_driver import flatten, unflatten
from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import params_to_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
#: name → (world size, model axis, SEQ of the ranks' script: 0 the batch of two,
#: 1 one sequence under ``shard_seq``, 2 both in turn)
WORLDS = {"2x2": (4, 2, 2), "1x2": (2, 2, 0), "4x1_seq": (4, 1, 1)}
#: what the tests hold: name → (world, key prefix, shard_seq)
SERVED = {"2x2": ("2x2", "", False), "1x2": ("1x2", "", False),
          "4x1_seq": ("4x1_seq", "", True), "2x2_seq": ("2x2", "seq/", True)}
TOL = 1e-5

_jprefill = jax.jit(jtf.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jtf.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _given() -> dict:
    """The driver's inputs: every case's parameters (the port's init) and,
    for a global batch of 1 and of 2, its prompt and decode tokens."""
    given = {}
    for i, name in enumerate(driver.CASES):
        cfg = driver.case_cfg(get_config, name)
        tree = params_to_numpy(Transformer(cfg, device="cpu").init(
            torch.Generator().manual_seed(70 + i)))
        given.update(flatten(tree, f"{name}/params"))
        rng = np.random.default_rng(80 + i)
        batch = {"tokens": rng.integers(
            0, cfg.vocab, (2, driver.PROMPT)).astype(np.int32)}
        if cfg.is_enc_dec:
            batch["frames"] = rng.standard_normal(
                (2, cfg.encoder_len, cfg.d_model), np.float32)
        if cfg.patch_positions:
            batch["patches"] = rng.standard_normal(
                (2, cfg.patch_positions, cfg.d_model), np.float32)
        steps = rng.integers(0, cfg.vocab, (driver.STEPS, 2, 1)).astype(
            np.int32)
        for b in (1, 2):  # the batch of one sequence is the first row
            given.update(flatten({k: v[:b] for k, v in batch.items()},
                                 f"{name}/b{b}/batch"))
            given[f"{name}/b{b}/steps"] = steps[:, :b]
    return given


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _first_row(tree):
    """A cache (or logits) of the first sequence only: every leaf but the
    positions cut to its first row (dim 1 of a stacked leaf)."""
    if isinstance(tree, dict):
        return {k: v if k == "pos" else _first_row(v)
                for k, v in tree.items()}
    return tree[:, :1] if tree.ndim > 2 else tree[:1]


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """{(case, batch): JAX's prefill logits, each step's logits, the cache
    after the prefill and after the last step}. The sequences of a batch
    are independent of each other but in a MoE layer (its capacity is the
    batch's): elsewhere the batch of one sequence's are the first row's of
    the batch of two."""
    given = _given()
    out = {}
    for name in driver.CASES:
        jcfg = driver.case_cfg(jget_config, name)
        tree = unflatten(given, name)
        params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
        for b in (2, 1):
            if b == 1 and jcfg.moe is None:
                logits, steps, first, last = out[(name, 2)]
                out[(name, 1)] = (logits[:1], [x[:1] for x in steps],
                                  _first_row(first), _first_row(last))
                continue
            inputs = tree[f"b{b}"]
            batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
            logits, cache = _jprefill(params, jcfg, batch, driver.MAX_LEN)
            first = _np(cache)
            steps = []
            for tok in inputs["steps"]:
                step_logits, cache = _jdecode(params, jcfg, cache,
                                              jnp.asarray(tok))
                steps.append(np.asarray(step_logits))
            out[(name, b)] = (np.asarray(logits), steps, first, _np(cache))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds' rank 0 results; JAX's references are computed
    while they run."""
    tmp = tmp_path_factory.mktemp("servemesh")
    np.savez(tmp / "in.npz", **_given())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, str(REPO / "tests" / "_torch_serve_mesh_driver.py")]
    procs = {key: [subprocess.Popen(
        cmd + [str(r), str(size), str(model), str(seq),
               str(tmp / f"store{key}"), str(tmp / "in.npz"),
               str(tmp / f"out{key}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(size)]
        for key, (size, model, seq) in WORLDS.items()}
    logs = {}
    try:
        _reference()
        for key, ranks in procs.items():
            logs[key] = [p.communicate(timeout=300)[0] for p in ranks]
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    out = {}
    for key, ranks in procs.items():
        report = "\n".join(f"--- {key} rank {r} ---\n{log}"
                           for r, log in enumerate(logs[key]))
        assert all(p.returncode == 0 for p in ranks), report
        with np.load(tmp / f"out{key}.npz") as f:
            out[key] = dict(f)
    return out


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _hold_cache(got: dict, want: dict, what) -> None:
    flat_got, flat_want = flatten(got, "c"), flatten(want, "c")
    assert set(flat_got) == set(flat_want), what
    for key, leaf in flat_want.items():
        mine = flat_got[key]
        assert mine.shape == leaf.shape, (what, key)
        if key.endswith("/pos"):
            np.testing.assert_array_equal(mine, leaf, err_msg=str(what))
        else:
            assert _rel(mine, leaf) <= TOL, (what, key, _rel(mine, leaf))


@pytest.mark.parametrize("served", list(SERVED))
@pytest.mark.parametrize("name", list(driver.CASES))
def test_sharded_serving_matches_jax(worlds, served, name):
    """The case's prefill and four decode steps over the world's mesh
    against JAX's one-device calls on the same global batch."""
    world, tag, shard_seq = SERVED[served]
    logits, steps, first, last = _reference()[(name,
                                               driver.batch_rows(shard_seq))]
    got = unflatten(worlds[world], name + (f"/{tag[:-1]}" if tag else ""))
    assert got["prefill"].shape == logits.shape
    assert _rel(got["prefill"], logits) <= TOL, \
        (world, name, _rel(got["prefill"], logits))
    for s, want in enumerate(steps):
        have = got["decode"][str(s)]
        assert _rel(have, want) <= TOL, (world, name, s, _rel(have, want))
    _hold_cache(got["cache"], first, (world, name, "prefill"))
    _hold_cache(got["cache_end"], last, (world, name, "decode"))


@pytest.mark.parametrize("name", list(driver.CASES))
def test_decode_issues_only_its_layouts_collectives(worlds, name):
    """A decode step at (2, 2): all-gathers and all-reduces only; no K or V
    leaf gathered (the slots' statistics are combined instead, and a
    split head dim gathers the attention's output); the slots over
    ``model`` (one kv head) combine with all-reduces; RWKV's ``shift`` is
    the only cache leaf gathered, at use."""
    got = [str(x) for x in worlds["2x2"][f"{name}/collectives"] if str(x)]
    kinds = {x.split("|")[0] for x in got}
    labels = {x.split("|")[1] for x in got}
    assert kinds <= {"all-gather", "all-reduce"}, (name, got)
    assert not labels & {"cache:k", "cache:v"}, (name, got)
    cache_leaves = {x for x in labels if x.startswith("cache:")
                    and not x.endswith(":out")}
    assert cache_leaves <= {"cache:shift"}, (name, got)
    if name == "rwkv6-1.6b":
        assert cache_leaves == {"cache:shift"}
    if name == "qwen_hd":
        assert "cache:k:out" in labels, got
    if name in ("qwen_mqa", "qwen_rows", "whisper_rows"):
        assert "all-reduce|" in got, got


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x22b"])
def test_one_rank_mesh_prefill_and_decode_are_the_mesh_less_ones_bit_for_bit(
        arch):
    """A one-rank `make_host_mesh`: the model sharded over it holds every
    parameter whole, the cache every leaf, and its prefill and decode,
    which run the mesh path (`Placement.bind`, every layer's split body)
    with nothing to exchange, give the mesh-less logits and cache bit for
    bit over four steps, with no collective recorded."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.weights import cache_to_numpy
    from repro_torch.sharding.collectives import recording
    from repro_torch.train import serve

    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12))}
    steps = rng.integers(0, cfg.vocab, (4, 2, 1))
    runs = []
    for mesh in (None, make_host_mesh(device="cpu")):
        model = Transformer(cfg, device="cpu").init(
            torch.Generator().manual_seed(4))
        if mesh is not None:
            model = serve.shard_model(model, mesh)
        prefill = serve.make_prefill(cfg, 32, "cpu", mesh=mesh)
        decode = serve.make_decode_step(cfg, "cpu", mesh=mesh)
        with recording() as record:
            logits, cache = prefill(model, batch)
            out = [logits] + [decode(model, cache, t)[0] for t in steps]
        assert record == []
        runs.append((out, cache_to_numpy(cache)))
    (a, ca), (b, cb) = runs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for key, leaf in flatten(ca, "c").items():
        np.testing.assert_array_equal(leaf, flatten(cb, "c")[key],
                                      err_msg=key)


def test_decode_graph_refuses_a_mesh_of_ranks():
    """`DecodeGraph` captures one rank's step: over a mesh of more ranks it
    raises, naming eager decode, before it touches a card."""
    from types import SimpleNamespace

    from repro_torch.train.serve import DecodeGraph

    model = SimpleNamespace(placement=SimpleNamespace(
        mesh=SimpleNamespace(size=4)))
    with pytest.raises(ValueError, match="make_decode_step"):
        DecodeGraph(model, None, {}, None)
