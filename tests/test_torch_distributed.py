"""The port's distribution (`repro_torch.core.distributed`, the data mesh of
`repro_torch.launch.mesh`, the engine's ``shard=``) against the JAX package.

In this process: `partition_fact_table` gives the reference's partitions row
for row; `partitioned_figaro_qr` without a mesh gives its R (the plain path
and the kernels' plain versions, padded and band assembly); on a one-rank
mesh `distributed_postprocess_r0` gives the reference's on its one-device
mesh and the butterfly returns its input; the JAX package's one-device-mesh
tests of ``shard=`` (tests/test_engine.py) hold for the port; the retrace
sanitizer names the mesh, and the numerics shadow re-runs a rank's rows.

Across processes: P ∈ {1, 2, 3, 4} gloo ranks (tests/_torch_distributed_driver.py,
one process per rank, a `FileStore`, a 60 s timeout on every group and a
300 s one on the processes) against the JAX package's answers on the same
inputs, computed here: the TSQR combine, fact partitions over the mesh, the
sharded batched kinds at a batch the mesh does not divide, the reference's
trace counts, every rank's R bit for bit, no collective on one rank, and
a server over the mesh built on every rank with rank 0 as its controller:
``qr/svd/pca/lsq`` answers in submission order, a poisoned request failing
alone on a rank ≥ 1's fault, answers before and after an append within
capacity and a regrow, the plans and the served Rs of every rank bit for
bit, a plan mismatch refused on every rank, collectives only from the
dispatch threads. Tolerance: float64, 1e-9 relative after `normalize_sign`
(tests/test_kernel_path.py:30).
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_distributed_driver as driver
from helpers import TOPOLOGIES, random_acyclic_db
from repro.core import distributed as jdist
from repro.core.engine import FigaroEngine as JaxEngine
from repro.core.join_tree import JoinTree as JaxJoinTree
from repro.core.join_tree import build_plan as jax_build_plan
from repro.core.materialize import materialize_join
from repro.core.plan_cache import build_capacity_plan as jax_capacity_plan
from repro.core.plan_cache import pad_data as jax_pad_data
from repro.core.plan_cache import refresh_plan as jax_refresh_plan
from repro.core.postprocess import normalize_sign as jax_normalize_sign
from repro.core.relation import Database as JaxDatabase
from repro.core.relation import full_reduce as jax_full_reduce
from repro.launch.mesh import make_data_mesh as jax_make_data_mesh
from repro_torch import figaro
from repro_torch.core import distributed as tdist
from repro_torch.core.engine import FigaroEngine
from repro_torch.core.figaro import figaro_r0
from repro_torch.core.join_tree import JoinTree, build_plan
from repro_torch.core.relation import Database, Relation
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.sanitizer import numerics as san_numerics
from repro_torch.sanitizer import retrace as san_retrace
from repro_torch import sanitizer

REPO = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64
RTOL = 1e-9
WORLDS = (1, 2, 3, 4)
CORNERS = [(False, "padded"), (False, "band"), (True, "padded"),
           (True, "band")]
# One JAX engine for every reference answer here: each signature compiles
# once for the whole file.
_JAX = JaxEngine(donate_data=False)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_tree(tree) -> JoinTree:
    rels = {r.name: Relation(r.name, r.key_attrs, r.data_attrs, r.keys,
                             r.data) for r in tree.db}
    return JoinTree(Database(rels), dict(tree.parent))


def _jax_star(tables):
    db = jax_full_reduce(JaxDatabase.from_arrays(tables), driver.STAR_EDGES)
    return JaxJoinTree.from_edges(db, "F", driver.STAR_EDGES)


def _star_pair():
    tables = driver.inputs(1)[0]
    return driver.star_tree(tables), _jax_star(tables)


def _cpu_mesh() -> DataMesh:
    return make_data_mesh(device="cpu")


def _batch(plan, rng, b):
    return tuple(rng.normal(size=(b,) + tuple(np.shape(d)))
                 for d in plan.data)


# -- fact partitions -----------------------------------------------------------


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES) + ["star"])
@pytest.mark.parametrize("num_parts", [1, 3, 1000])
def test_partition_fact_table_matches_reference(topology, num_parts):
    """The same partitions, key for key and row for row, with ``num_parts``
    beyond the number of key groups too (every group its own partition)."""
    if topology == "star":
        t_tree, j_tree = _star_pair()
    else:
        _, j_tree, _ = random_acyclic_db(topology, np.random.default_rng(5),
                                         max_rows=12)
        t_tree = _port_tree(j_tree)
    t_parts = tdist.partition_fact_table(t_tree, num_parts)
    j_parts = jdist.partition_fact_table(j_tree, num_parts)
    assert len(t_parts) == len(j_parts) > 0
    root = j_tree.root
    assert sum(t.db[root].num_rows for t in t_parts) == \
        j_tree.db[root].num_rows
    for t, j in zip(t_parts, j_parts):
        assert t.parent == j.parent
        assert t.db.names == j.db.names
        for name in j.db.names:
            np.testing.assert_array_equal(t.db[name].keys, j.db[name].keys)
            np.testing.assert_array_equal(t.db[name].data, j.db[name].data)


@pytest.mark.parametrize("use_kernel,assembly", CORNERS)
def test_partitioned_figaro_qr_without_mesh_matches_reference(use_kernel,
                                                              assembly):
    """Two partitions through the shared engine, TSQR-combined: the
    reference's R at 1e-9 (the kernel path on the kernels' plain versions,
    the reference's in Pallas interpret mode). Four partitions, over a mesh
    too, are `test_gloo_ranks_match_reference`'s."""
    t_tree, j_tree = _star_pair()
    r = tdist.partitioned_figaro_qr(t_tree, 2, use_kernel=use_kernel,
                                    assembly=assembly, device="cpu")
    r_ref = jdist.partitioned_figaro_qr(
        j_tree, 2, use_kernel=use_kernel, assembly=assembly, engine=_JAX)
    assert r.dtype == F64 and r.shape == tuple(r_ref.shape)
    assert _rel(r, r_ref) < RTOL


def test_partitioned_qr_through_the_session():
    """`Session.partitioned_qr`: float64 by default, the session's engine,
    and the single-device R of the same tree."""
    t_tree, j_tree = _star_pair()
    sess = figaro.Session(device="cpu", use_kernel=True, assembly="band")
    r = sess.partitioned_qr(t_tree, 2)
    assert r.dtype == F64
    assert sess.engine.trace_count("qr") == 2  # one miss per partition
    r1 = sess.partitioned_qr(t_tree, 2, mesh=_cpu_mesh())
    assert _rel(r1, r) < RTOL
    assert sess.engine.trace_count("qr") == 2  # the same signatures
    r_ref = jdist.partitioned_figaro_qr(j_tree, 2, engine=_JAX)
    assert _rel(r, r_ref) < RTOL


# -- the TSQR combine on one rank ----------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_distributed_postprocess_r0_one_rank_mesh_matches_reference(
        use_kernel):
    """The reference on its one-device mesh, with its plain panels: its
    Pallas panel kernel does not trace inside its ``shard_map`` (no ``vma``
    on the kernel's output shapes), so ``use_kernel=True`` (the port's panel
    kernel's plain version) is held to the reference's XLA path."""
    t_tree, j_tree = _star_pair()
    r0 = figaro_r0(build_plan(t_tree), dtype=F64, device="cpu")
    r = tdist.distributed_postprocess_r0(r0, _cpu_mesh(),
                                         use_kernel=use_kernel)
    j_r0 = _JAX.r0(jax_build_plan(j_tree), dtype=jnp.float64)
    r_ref = jdist.distributed_postprocess_r0(j_r0, jax_make_data_mesh())
    assert _rel(r, r_ref) < RTOL
    x = np.random.default_rng(3).normal(size=(257, 9))
    got = tdist.distributed_qr_r(torch.as_tensor(x), _cpu_mesh())
    want = jax_normalize_sign(jnp.linalg.qr(jnp.asarray(x), mode="r"))
    assert _rel(got, want) < RTOL


def test_butterfly_on_one_rank_returns_its_input():
    r = torch.triu(torch.randn(5, 5, dtype=F64))
    assert tdist.butterfly_qr_combine(r, _cpu_mesh()) is r


def test_make_data_mesh_without_a_process_group():
    mesh = _cpu_mesh()
    assert mesh.shape == {"data": 1} and mesh.size == 1 and mesh.rank == 0
    assert mesh.group is None and mesh.device == torch.device("cpu")
    assert make_data_mesh(1, device="cpu").signature == mesh.signature
    for bad in (0, 2):
        with pytest.raises(ValueError, match=rf"num_devices={bad} outside "
                                             r"\[1, 1\]"):
            make_data_mesh(bad, device="cpu")
    outside = DataMesh(group=None, size=2, rank=None, device=mesh.device,
                       ranks=(0, 1), backend="gloo")
    with pytest.raises(ValueError, match="holds no rank"):
        tdist.distributed_qr_r(torch.ones(4, 2, dtype=F64), outside)


def test_mesh_lends_its_process_groups_and_does_not_own_them(tmp_path):
    """A mesh kept alive past `destroy_process_group` (a server over it is
    often held in a reference cycle until the interpreter exits) must not
    keep its groups, and their gloo threads, running into the
    interpreter's teardown."""
    import weakref

    import torch.distributed as dist

    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_data_mesh()
        group = weakref.ref(mesh.group)
        assert isinstance(group(), dist.ProcessGroup)
        assert mesh.control is None and mesh.size == 1
        cycle = [mesh]
        cycle.append(cycle)
    finally:
        dist.destroy_process_group()
    assert group() is None
    with pytest.raises(RuntimeError, match="mesh's group was destroyed"):
        mesh.group
    assert cycle[0].signature == (1, 0, "gloo")


# -- shard= on the one-rank mesh (tests/test_engine.py:310, :336, :356) --------


def test_sharded_dispatch_single_device_mesh():
    """shard= on a one-rank mesh: the unsharded batched dispatch's results,
    a cache entry of its own (the mesh signature), shard= without batched
    rejected, an axis not in the mesh rejected."""
    rng = np.random.default_rng(0)
    plan = build_plan(_star_pair()[0])
    engine = FigaroEngine(donate_data=False)
    batch = _batch(plan, rng, 3)
    mesh = _cpu_mesh()
    r_plain = engine.qr(plan, batch, batched=True, dtype=F64, device="cpu")
    r_shard = engine.qr(plan, batch, batched=True, shard=mesh, dtype=F64)
    torch.testing.assert_close(r_shard, r_plain, rtol=0, atol=1e-12)
    assert engine.trace_count("qr_batched") == 2  # mesh vs None signatures
    engine.qr(plan, batch, batched=True, shard=mesh, dtype=F64)
    assert engine.trace_count("qr_batched") == 2
    with pytest.raises(ValueError, match="batched"):
        engine.qr(plan, [d[0] for d in batch], shard=mesh, dtype=F64)
    with pytest.raises(ValueError, match="axis"):
        engine.qr(plan, batch, batched=True, shard=(mesh, "model"),
                  dtype=F64)
    with pytest.raises(ValueError, match="explicit"):
        engine.qr(plan, batched=True, shard=mesh, dtype=F64)
    with pytest.raises(TypeError, match="DataMesh"):
        engine.qr(plan, batch, batched=True, shard=object(), dtype=F64)


def test_sharded_dispatch_empty_batch():
    """B = 0: nothing to split; correctly shaped empty results."""
    plan = build_plan(_star_pair()[0])
    engine = FigaroEngine(donate_data=False)
    mesh = _cpu_mesh()
    n = plan.num_cols
    empty = tuple(np.zeros((0,) + np.shape(d)) for d in plan.data)
    r = engine.qr(plan, empty, batched=True, shard=mesh, dtype=F64)
    assert r.shape == (0, n, n)
    betas, resids = engine.least_squares(plan, n - 1, empty, batched=True,
                                         shard=mesh, dtype=F64)
    assert betas.shape == (0, n - 1) and resids.shape == (0,)


def test_sharded_dispatch_single_request_batch():
    """B = 1 matches the unsharded single dispatch."""
    plan = build_plan(_star_pair()[0])
    engine = FigaroEngine(donate_data=False)
    batch = _batch(plan, np.random.default_rng(1), 1)
    r_shard = engine.qr(plan, batch, batched=True, shard=_cpu_mesh(),
                        dtype=F64)
    r_plain = engine.qr(plan, [d[0] for d in batch], dtype=F64,
                        device="cpu")
    assert r_shard.shape[0] == 1
    torch.testing.assert_close(r_shard[0], r_plain, rtol=0, atol=1e-12)


def test_staged_shard_is_checked_against_its_dispatch():
    """``stage(shard=)`` tags its rows with the mesh and the padded size;
    the dispatch takes them as they are, refuses another padded size, and
    an unsharded dispatch refuses them; rows already this rank's
    (``live=``, as a serving controller sends them) stage as they are."""
    plan = build_plan(_star_pair()[0])
    engine = FigaroEngine(donate_data=False)
    batch = _batch(plan, np.random.default_rng(2), 3)
    mesh = _cpu_mesh()
    staged = engine.stage(batch, shard=mesh)
    assert staged.shard == ((mesh.signature, "data"), 3, 3)
    r = engine.qr(plan, staged, batched=True, shard=mesh, dtype=F64)
    assert torch.equal(r, engine.qr(plan, batch, batched=True, shard=mesh,
                                    dtype=F64))
    with pytest.raises(ValueError, match="staged for mesh"):
        engine.qr(plan, staged, batched=True, shard=mesh, batch_capacity=4,
                  dtype=F64)
    with pytest.raises(ValueError, match="same shard="):
        engine.qr(plan, staged, batched=True, dtype=F64, device="cpu")
    # at a bucket, and rows that are already this rank's (``live=``)
    padded = engine.stage(batch, shard=mesh, batch_capacity=4)
    assert padded.shard == ((mesh.signature, "data"), 3, 4)
    rows = engine.stage(list(padded), shard=mesh, batch_capacity=4, live=3)
    assert rows.shard == padded.shard
    assert torch.equal(engine.qr(plan, rows, batched=True, shard=mesh,
                                 batch_capacity=4, dtype=F64), r)
    with pytest.raises(ValueError, match="each rank 2 rows"):
        engine.stage(batch, shard=mesh, live=2)


def test_session_mesh_shards_batched_calls():
    """``Session(mesh=)`` shards batched façade calls (one miss per mesh
    signature, JoinDataset included); single calls and ``shard=None`` stay
    unsharded."""
    t_tree, _ = _star_pair()
    mesh = _cpu_mesh()
    sess = figaro.Session(device="cpu", mesh=mesh, dtype=F64)
    ds = sess.from_tree(t_tree)
    batch = _batch(ds.plan, np.random.default_rng(4), 2)
    r = ds.qr(batch)
    assert r.shape[0] == 2
    key = next(k for k in sess.engine._cache if k[0] == "qr_batched")
    assert key[-1] == (mesh.signature, "data")
    plain = ds.qr(batch, shard=None)
    torch.testing.assert_close(r, plain, rtol=0, atol=1e-12)
    assert sess.engine.trace_count("qr_batched") == 2
    assert ds.qr().shape == r.shape[1:]
    with pytest.raises(TypeError, match="DataMesh"):
        figaro.Session(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="axis"):
        figaro.Session(device="cpu", mesh=mesh, shard_axis="model")


# -- the sanitizer on a sharded dispatch ----------------------------------------


def test_sanitizer_retrace_and_shadow_on_a_sharded_dispatch():
    """Retrace attribution names the mesh; the float64 shadow of a sampled
    float32 sharded dispatch re-runs this rank's rows."""
    plan = build_plan(_star_pair()[0])
    batch = _batch(plan, np.random.default_rng(6), 3)
    sanitizer.enable(sample_every=1)
    sanitizer.reset()
    try:
        engine = FigaroEngine(donate_data=False)
        engine.qr(plan, batch, batched=True, device="cpu")
        engine.qr(plan, batch, batched=True, shard=_cpu_mesh())
        assert san_retrace.last_trace("qr_batched").diverged == ["mesh"]
        events = [e for e in san_numerics.events()
                  if e["kind"] == "qr_batched"]
        assert len(events) == 2 and events[0]["dtype"] == "float32"
        assert all(e["rel_err"] <= e["budget"] for e in events)
        assert sanitizer.findings("numerics") == []
    finally:
        sanitizer.reset()
        sanitizer.disable()


# -- P gloo ranks, one process each ---------------------------------------------


def _spawn(world: int, tmp_path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path / "ranks.npz"
    cmd = [sys.executable, str(REPO / "tests" / "_torch_distributed_driver.py")]
    procs = [subprocess.Popen(cmd + [str(r), str(world),
                                     str(tmp_path / "store"), str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"--- rank {r} ---\n{log}"
                       for r, log in enumerate(logs))
    assert all(p.returncode == 0 for p in procs), report
    with np.load(out) as f:
        return dict(f)


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """The JAX package's answers on the driver's inputs, for the largest
    batch (a smaller mesh's batch is its leading requests)."""
    tables, x, x_odd, batch = driver.inputs(max(WORLDS))
    j_tree = _jax_star(tables)
    j_plan = jax_build_plan(j_tree)
    n = j_plan.num_cols
    a = jnp.asarray(materialize_join(j_tree))
    ref = {"r": jax_normalize_sign(jnp.linalg.qr(a, mode="r")),
           "r_part": jdist.partitioned_figaro_qr(j_tree, 4, engine=_JAX)}
    for key, mat in (("r_qr", x), ("r_qr_odd", x_odd)):
        ref[key] = jax_normalize_sign(jnp.linalg.qr(jnp.asarray(mat),
                                                    mode="r"))
    per = []
    for i in range(len(batch[0])):
        req = [d[i] for d in batch]
        s_i, vt_i = _JAX.svd(j_plan, req, dtype=jnp.float64)
        pca_i = _JAX.pca(j_plan, req, k=3, dtype=jnp.float64)
        beta_i, resid_i = _JAX.least_squares(j_plan, n - 1, req, ridge=0.25,
                                             dtype=jnp.float64)
        per.append({"qr": _JAX.qr(j_plan, req, dtype=jnp.float64),
                    "svd_s": s_i, "svd_vt": np.asarray(vt_i),
                    "pca_ev": pca_i.explained_variance,
                    "pca_mean": pca_i.mean, "lsq_beta": beta_i,
                    "lsq_resid": resid_i})
    ref["per_sample"] = per
    ref["appended"] = _appended_reference(tables, j_tree)
    return ref


def _appended_reference(tables, j_tree) -> list:
    """The JAX engine's lsq(ridge=0.25) answers on the plan after each of
    the driver's appends (`refresh_plan` of the capacity plan), for the
    requests the driver sends after it (padded to capacity)."""
    t_tree = driver.star_tree(tables)
    plan = jax_capacity_plan(j_tree)
    n = plan.spec.num_cols
    out = []
    for (node, rows), reqs in zip(driver.appends(t_tree),
                                  driver.appended_requests(t_tree)):
        plan = jax_refresh_plan(plan, {node: rows})
        per = [_JAX.least_squares(plan, n - 1,
                                  jax_pad_data(list(r), plan.spec),
                                  ridge=0.25, dtype=jnp.float64)
               for r in reqs]
        out.append((np.stack([np.asarray(b) for b, _ in per]),
                    np.stack([np.asarray(r) for _, r in per])))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_ranks_match_reference(world, tmp_path):
    res = _spawn(world, tmp_path)
    ref = _reference()

    # the TSQR combine and the fact partitions
    for key in ("r_qr", "r_qr_odd"):
        assert _rel(res[key], ref[key]) < RTOL, key
    assert _rel(res["r_dist"], ref["r"]) < RTOL
    assert _rel(res["r_part"], ref["r_part"]) < RTOL
    assert _rel(res["r_part"], ref["r"]) < RTOL
    assert _rel(res["r_part_many"], ref["r"]) < RTOL

    # the sharded kinds against the reference engine's per-sample answers
    b = driver.batch_size(world)
    assert res["qr_batched"].shape[0] == b
    for i, want in enumerate(ref["per_sample"][:b]):
        for key in ("qr", "svd_s", "pca_ev", "pca_mean", "lsq_beta",
                    "lsq_resid"):
            got = res["qr_batched" if key == "qr" else key][i]
            assert _rel(got, want[key]) < RTOL, (key, i)
        vt = want["svd_vt"]  # singular vectors up to the sign of each row
        for got_vt in (res["svd_vt"][i], res["served_svd_vt"][i]):
            sgn = np.sign(np.sum(got_vt * vt, axis=1))[:, None]
            assert _rel(got_vt * sgn, vt) < 1e-8
        # served over the mesh: rank 0's controller, every rank's rows
        for key in ("qr", "svd_s", "pca_ev", "pca_mean", "lsq_beta",
                    "lsq_resid"):
            assert _rel(res[f"served_{key}"][i], want[key]) < RTOL, (key, i)
    # after an append within capacity, then after a regrow
    for k, (beta, resid) in enumerate(ref["appended"], start=1):
        assert _rel(res[f"appended{k}_beta"], beta) < RTOL, k
        assert _rel(res[f"appended{k}_resid"], resid) < RTOL, k
    # the poisoned request failed alone, on a rank >= 1's fault
    assert int(res["poison"][0]) >= 1

    # the JAX package's sharded driver's trace counts: one miss, none on a
    # repeat, a staged batch or another live size in the bucket, one more
    # for a sub-mesh
    assert res["trace_counts"].tolist() == [1, 1, 1] + ([2] if world > 1
                                                        else [])
    assert res["stable"].all()
    if world == 1:
        assert int(res["collectives"]) == 0
    else:
        assert int(res["collectives"]) > 0
        assert res["bit_identical"].all(), res["bit_identical"]
