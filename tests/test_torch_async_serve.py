"""The port's async serving (`repro_torch.train.async_serve`,
`repro_torch.train.serve`, `repro_torch.launch.mesh`) on the CPU.

The counterpart of every test of tests/test_async_serve.py: batch buckets,
``batch_capacity=`` sharing one signature across live sizes, coalesced
answers equal to the synchronous batched dispatch bit for bit, futures in
submission order, sub-batches, B=0/B=1, validation and poisoned-dispatch
isolation, interleaved submit/append with no signature miss, the shared
plan holder, pause/append, ``max_batch``, abandoned threads, constructor
validation, and a server over a one-rank data mesh (a mesh of more ranks
without the control group of `make_data_mesh` is refused; servers over
P > 1 gloo ranks are tests/test_torch_distributed.py's). Then the port's
server against the JAX
package's (`repro.train.serve.make_figaro_server`) for every serving kind:
the same requests (numpy, from a seed), float64, answers equal to 1e-9
relative (R after `normalize_sign`, singular vectors and components up to
sign). Last, the engine's serving contract: ``donate_data`` drops the
engine's references once the request is consumed and changes no result;
``stage`` passes everything through on the CPU, and ``stage(shard=)`` takes
a rank's rows. The port runs on the CPU.
"""

import gc
import queue
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import FigaroEngine as JaxEngine
from repro.core.join_tree import build_plan as jax_build_plan
from repro.core.join_tree import JoinTree as JaxJoinTree
from repro.core.relation import Database as JaxDatabase
from repro.core.relation import full_reduce as jax_full_reduce
from repro.train.serve import make_figaro_server as jax_make_figaro_server
from repro_torch import figaro
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import FigaroEngine, Staged
from repro_torch.core.join_tree import JoinTree, build_plan
from repro_torch.core.plan_cache import PlanHolder, build_capacity_plan
from repro_torch.core.postprocess import normalize_sign
from repro_torch.core.relation import Database, full_reduce
from repro_torch.launch.mesh import (DataMesh, make_data_mesh,
                                     serving_batch_capacity)
from repro_torch.train import async_serve as asv
from repro_torch.train.async_serve import FigaroFuture
from repro_torch.train.serve import (AsyncFigaroServer, FigaroServer,
                                     SERVE_KINDS, make_figaro_server)

F64 = torch.float64
_STAR_EDGES = [("Orders", "Customers"), ("Orders", "Products")]


def _star_tables(m_fact: int = 20):
    rng = np.random.default_rng(m_fact)
    return {
        "Orders": ({"cust": np.arange(m_fact) % 8,
                    "prod": np.arange(m_fact) % 4},
                   rng.normal(size=(m_fact, 2)), ["amount", "qty"]),
        "Customers": ({"cust": np.arange(8)},
                      rng.normal(size=(8, 2)), ["age", "income"]),
        "Products": ({"prod": np.arange(4)},
                     rng.normal(size=(4, 1)), ["price"]),
    }


def _star_tree():
    db = full_reduce(Database.from_arrays(_star_tables()), _STAR_EDGES)
    return JoinTree.from_edges(db, "Orders", _STAR_EDGES)


def _star_ds(session, m_fact=20):
    return session.ingest(_star_tables(m_fact)).join("Orders", _STAR_EDGES)


def _requests(plan, rng, n):
    """n single requests (per-node [m_i, n_i] leaves) at capacity shapes."""
    return [tuple(rng.normal(size=np.shape(d)) for d in plan.data)
            for _ in range(n)]


def _stack(reqs):
    return tuple(np.stack([r[j] for r in reqs])
                 for j in range(len(reqs[0])))


def _server(plan, **kw):
    kw.setdefault("engine", FigaroEngine(donate_data=False))
    return make_figaro_server(plan, kind=kw.pop("kind", "qr"), dtype=F64,
                              device="cpu", **kw)


# -- capacity bucketing -------------------------------------------------------


def test_serving_batch_capacity_buckets():
    assert serving_batch_capacity(0) == 0
    assert serving_batch_capacity(1) == 1
    assert serving_batch_capacity(3) == 4
    assert serving_batch_capacity(8) == 8
    # aligned to a non-power-of-two mesh axis
    assert serving_batch_capacity(1, axis_size=3) == 3
    assert serving_batch_capacity(5, axis_size=3) == 9
    assert serving_batch_capacity(4, axis_size=2) == 4
    # the serving mesh on one process: one rank, axis size 1
    assert make_data_mesh(device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match=r"outside \[1, 1\]"):
        make_data_mesh(2, device="cpu")


def test_engine_batch_capacity_shares_signature_across_live_sizes(rng):
    """Partial batches padded to one bucket share one signature; the pad is
    sliced off the result, which equals the unpadded dispatch's."""
    plan = build_plan(_star_tree())
    engine = FigaroEngine(donate_data=False)
    b3 = _stack(_requests(plan, rng, 3))
    b5 = _stack(_requests(plan, rng, 5))
    r3 = engine.qr(plan, b3, batched=True, batch_capacity=8, dtype=F64,
                   device="cpu")
    assert r3.shape == (3, plan.num_cols, plan.num_cols)
    assert engine.trace_count("qr_batched") == 1
    r5 = engine.qr(plan, b5, batched=True, batch_capacity=8, dtype=F64,
                   device="cpu")
    assert r5.shape[0] == 5
    assert engine.trace_count("qr_batched") == 1, \
        "live sizes in one batch bucket must share the signature"
    assert torch.equal(r5, engine.qr(plan, b5, batched=True, dtype=F64,
                                     device="cpu"))
    with pytest.raises(ValueError, match="batch_capacity"):
        engine.qr(plan, b5, batched=True, batch_capacity=2, dtype=F64,
                  device="cpu")
    with pytest.raises(ValueError, match="batched"):
        engine.qr(plan, [d[0] for d in b3], batch_capacity=4, dtype=F64,
                  device="cpu")


# -- futures + coalescing -----------------------------------------------------


def test_coalesced_submit_bit_identical_to_sync_batched_dispatch(rng):
    """pause + submit×4 + resume dispatches ONE coalesced B=4 batch whose
    per-request results are bit-identical to the one-shot batched dispatch of
    the same batch (same engine, same signature)."""
    plan = build_plan(_star_tree())
    engine = FigaroEngine(donate_data=False)
    server = _server(plan, engine=engine)
    reqs = _requests(plan, rng, 4)
    server.pause()
    futures = [server.submit(r) for r in reqs]
    server.resume()
    results = [f.result(timeout=60) for f in futures]
    assert engine.trace_count("qr_batched") == 1, \
        "4 submits must coalesce into one dispatch"
    r_sync = engine.qr(plan, _stack(reqs), batched=True, dtype=F64,
                       device="cpu")
    assert engine.trace_count("qr_batched") == 1  # same signature
    for i, r in enumerate(results):
        assert torch.equal(r, r_sync[i]), f"request {i}"
    server.close()


def test_futures_resolve_in_submission_order(monkeypatch):
    plan = build_plan(_star_tree())
    server = _server(plan)
    order = []
    orig = FigaroFuture._resolve

    def spy(self, *a, **k):
        order.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(FigaroFuture, "_resolve", spy)
    futures = [server.submit(r)
               for r in _requests(plan, np.random.default_rng(0), 6)]
    server.flush()
    assert all(f.done() for f in futures)
    assert order == futures, "futures must resolve in submission order"
    server.close()


def test_submit_sub_batch_and_call_are_equivalent(rng):
    plan = build_plan(_star_tree())
    server = _server(plan)
    batch = _stack(_requests(plan, rng, 3))
    via_future = server.submit(batch).result(timeout=60)
    via_call = server(batch)
    assert via_future.shape == (3, plan.num_cols, plan.num_cols)
    assert torch.equal(via_future, via_call)
    server.close()


def test_edge_batches_b0_and_b1(rng):
    plan = build_plan(_star_tree())
    server = _server(plan)
    n = plan.num_cols
    empty = tuple(np.zeros((0,) + np.shape(d)) for d in plan.data)
    assert server.submit(empty).result(timeout=60).shape == (0, n, n)
    one = _stack(_requests(plan, rng, 1))
    r1 = server.submit(one).result(timeout=60)
    assert r1.shape == (1, n, n)
    # single-request submit: unbatched leaves in, unbatched result out
    single = server.submit(tuple(d[0] for d in one)).result(timeout=60)
    assert torch.equal(single, r1[0])
    server.close()


# -- per-request exception isolation ------------------------------------------


def test_validation_error_fails_only_its_own_future(rng):
    plan = build_plan(_star_tree())
    server = _server(plan)
    good = _requests(plan, rng, 2)
    bad = tuple(d[:-1] for d in good[0])  # wrong row counts everywhere
    server.pause()
    f_ok1 = server.submit(good[0])
    f_bad = server.submit(bad)
    f_ok2 = server.submit(good[1])
    server.resume()
    r1 = f_ok1.result(timeout=60)
    r2 = f_ok2.result(timeout=60)
    assert r1.shape == r2.shape == (plan.num_cols, plan.num_cols)
    with pytest.raises(ValueError, match="live size|rebuild request"):
        f_bad.result(timeout=60)
    assert isinstance(f_bad.exception(), ValueError)
    server.close()


def test_poisoned_dispatch_does_not_fail_coalesced_batchmates(rng):
    """If the coalesced dispatch itself blows up, each batched request is
    re-dispatched alone: batchmates succeed, only the poisoned request's
    future carries the exception."""
    plan = build_plan(_star_tree())
    server = _server(plan)
    real = server._dispatch_fn

    def flaky(plan_, batch, cap):
        if any(np.isnan(np.asarray(d)).any() for d in batch):
            raise RuntimeError("poisoned request batch")
        return real(plan_, batch, cap)

    server._dispatch_fn = flaky
    good = _requests(plan, rng, 2)
    poisoned = tuple(np.asarray(d).copy() for d in good[0])
    poisoned[0][0, 0] = np.nan
    server.pause()
    f1 = server.submit(good[0])
    f2 = server.submit(poisoned)
    f3 = server.submit(good[1])
    server.resume()
    r1 = f1.result(timeout=60)
    r3 = f3.result(timeout=60)
    with pytest.raises(RuntimeError, match="poisoned"):
        f2.result(timeout=60)
    # batchmates got real answers (match a clean per-request dispatch)
    ref = FigaroEngine(donate_data=False)
    for r, req in ((r1, good[0]), (r3, good[1])):
        ri = ref.qr(plan, list(req), dtype=F64, device="cpu")
        assert float((r - ri).abs().max()) <= 1e-10 * max(
            float(ri.abs().max()), 1.0)
    server.close()


# -- streaming submit/append with no signature miss ---------------------------


def test_interleaved_submit_append_zero_misses_in_capacity(rng):
    sess = figaro.Session(headroom=16, device="cpu")
    ds = _star_ds(sess)
    server = ds.serve(kind="qr", dtype=F64)
    live = lambda: tuple(
        rng.normal(size=(ds.stats()["nodes"][nm]["live_rows"],
                         ds.tree.db[nm].num_data_cols))
        for nm in ds.tree.preorder())
    for step in range(3):
        r = server.submit(live()).result(timeout=60)
        assert r.shape == (ds.plan.num_cols, ds.plan.num_cols)
        in_cap = server.append("Orders", ({"cust": np.array([step]),
                                           "prod": np.array([step % 4])},
                                          np.ones((1, 2)) * step))
        assert in_cap, "append within headroom must keep the signature"
    server.submit(live()).result(timeout=60)
    st = ds.stats()
    assert st["traces"]["qr_batched"] == 1, \
        "streaming submit+append in capacity must not miss"
    assert st["appends"] == 3 and st["regrows"] == 0
    server.close()


def test_append_drains_in_flight_requests(rng):
    """append must answer queued requests (validated against the old
    capacities) before swapping the plan."""
    sess = figaro.Session(headroom=16, device="cpu")
    ds = _star_ds(sess)
    server = ds.serve(kind="qr", dtype=F64)
    reqs = _requests(ds.plan, rng, 3)
    server.pause()
    futures = [server.submit(r) for r in reqs]
    server.resume()
    server.append("Orders", ({"cust": np.array([0]), "prod": np.array([0])},
                             np.ones((1, 2))))
    assert all(f.done() for f in futures), "append must drain the queue"
    for f in futures:
        assert f.result().shape == (ds.plan.num_cols, ds.plan.num_cols)
    server.close()


# -- shared plan holder: no dataset/server fork -------------------------------


def test_server_append_keeps_dataset_in_sync_and_vice_versa():
    sess = figaro.Session(headroom=16, device="cpu")
    ds = _star_ds(sess)
    server = ds.serve(kind="qr", dtype=F64)
    live0 = ds.stats()["nodes"]["Orders"]["live_rows"]

    # server -> dataset
    assert server.append("Orders", ({"cust": np.array([0, 1]),
                                     "prod": np.array([0, 1])},
                                    np.ones((2, 2))))
    assert ds.stats()["nodes"]["Orders"]["live_rows"] == live0 + 2
    assert ds.plan is server.plan, "dataset and server plan state forked"
    assert ds.stats()["appends"] == 1

    # dataset -> server
    assert ds.append("Orders", {"cust": np.array([2]),
                                "prod": np.array([2])}, np.ones((1, 2)))
    assert server.plan is ds.plan
    rows = int(server.plan.source_tree.db["Orders"].num_rows)
    assert rows == live0 + 3
    assert ds.stats()["appends"] == 2

    # two servers over one dataset share the same holder too
    server2 = ds.serve(kind="svd", dtype=F64)
    assert server2.plan is server.plan
    server.close()
    server2.close()


# -- surface contracts --------------------------------------------------------


def test_serve_kinds_single_source_of_truth():
    assert figaro.SERVE_KINDS == SERVE_KINDS == ("qr", "svd", "pca", "lsq")
    from repro_torch.api import SERVE_KINDS as api_kinds

    assert api_kinds is SERVE_KINDS
    assert figaro.AsyncFigaroServer is AsyncFigaroServer
    assert figaro.FigaroFuture is FigaroFuture
    # one validator, both surfaces
    ds = _star_ds(figaro.Session(device="cpu"))
    with pytest.raises(ValueError, match="supported kinds: qr, svd, pca, lsq"):
        ds.serve(kind="cholesky")
    cap = build_capacity_plan(_star_tree())
    with pytest.raises(ValueError, match="supported kinds: qr, svd, pca, lsq"):
        make_figaro_server(cap, kind="cholesky", device="cpu")


def test_sync_server_is_async_server():
    cap = build_capacity_plan(_star_tree())
    server = _server(cap)
    assert isinstance(server, FigaroServer)
    assert isinstance(server, AsyncFigaroServer)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(tuple(np.asarray(d) for d in cap.data))
    server.close()  # idempotent


def test_append_on_paused_server_does_not_deadlock(rng):
    """flush/append release a pause() hold: append drains every attached
    server, so a held coalescer with queued work must drain, not deadlock."""
    sess = figaro.Session(headroom=16, device="cpu")
    ds = _star_ds(sess)
    server = ds.serve(kind="qr", dtype=F64)
    server.pause()
    fut = server.submit(_requests(ds.plan, rng, 1)[0])
    # no resume(): append itself must release the hold and drain
    assert ds.append("Orders", {"cust": np.array([0]),
                                "prod": np.array([0])}, np.ones((1, 2)))
    assert fut.done()
    server.close()


def test_coalescer_respects_max_batch_for_sub_batches(rng):
    """Two B=3 sub-batches under max_batch=4 must dispatch as two groups
    (caps 4+4), never one coalesced B=6 group in a B=8 bucket."""
    plan = build_plan(_star_tree())
    server = _server(plan, max_batch=4)
    seen = []
    real = server._dispatch_fn

    def spy(plan_, batch, cap):
        seen.append((int(np.shape(batch[0])[0]), cap))
        return real(plan_, batch, cap)

    server._dispatch_fn = spy
    b3 = _stack(_requests(plan, rng, 3))
    server.pause()
    futures = [server.submit(b3), server.submit(b3)]
    server.resume()
    for f in futures:
        assert f.result(timeout=60).shape[0] == 3
    assert seen == [(3, 4), (3, 4)], seen
    server.close()


def test_abandoned_server_threads_exit():
    """Dropping a server without close() must not leak its worker threads:
    the finalizer's shutdown reaches both loops even though the weakref is
    already dead."""
    cap = build_capacity_plan(_star_tree())
    server = _server(cap)
    server(tuple(np.asarray(d) for d in cap.data))  # starts the threads
    threads = list(server._threads)
    assert all(t.is_alive() for t in threads)
    del server
    gc.collect()
    deadline = time.time() + 10.0
    while any(t.is_alive() for t in threads) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in threads), \
        "abandoned server leaked its dispatch/completion threads"


def test_complete_loop_fails_inflight_futures_when_server_dies():
    """A group already dispatched to the completion queue when the server is
    collected must fail its futures, not leave them unresolved forever."""
    item = asv._Request()
    later = asv._Request()
    out_q = queue.Queue()
    out_q.put(([item], [item], None))
    out_q.put(([later], [later], None))
    asv._complete_loop(lambda: None, out_q)  # dead weakref from the start
    for it in (item, later):
        assert it.future.done()
        with pytest.raises(RuntimeError, match="garbage-collected"):
            it.future.result(timeout=0)


def test_constructor_validation():
    cap = build_capacity_plan(_star_tree())
    with pytest.raises(ValueError, match="max_batch"):
        make_figaro_server(cap, kind="qr", max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="queue_depth"):
        make_figaro_server(cap, kind="qr", queue_depth=0, device="cpu")
    with pytest.raises(ValueError, match="built plan"):
        AsyncFigaroServer(PlanHolder(), lambda *a: None)
    with pytest.raises(ValueError, match="needs label_col"):
        make_figaro_server(cap, kind="lsq", device="cpu")
    with pytest.raises(TypeError, match="DataMesh"):
        make_figaro_server(cap, kind="qr", mesh=object(), device="cpu")
    mesh = make_data_mesh(device="cpu")
    with pytest.raises(ValueError, match="axis"):
        make_figaro_server(cap, kind="qr", mesh=mesh, shard_axis="model",
                           device="cpu")
    # several ranks need the control group that carries rank 0's stream
    two = DataMesh(group=None, size=2, rank=0, device=mesh.device,
                   ranks=(0, 1), backend="gloo")
    with pytest.raises(ValueError, match="control group"):
        make_figaro_server(cap, kind="qr", mesh=two, device="cpu")
    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_figaro_server(cap, kind="qr")


# -- the server over a one-rank data mesh --------------------------------------


def test_async_server_over_data_mesh_matches_per_sample(rng):
    plan = build_plan(_star_tree())
    engine = FigaroEngine(donate_data=False)
    mesh = make_data_mesh(device="cpu")
    server = make_figaro_server(plan, kind="qr", dtype=F64, engine=engine,
                                mesh=mesh, device="cpu")
    reqs = _requests(plan, rng, 3)
    server.pause()
    futures = [server.submit(r) for r in reqs]
    server.resume()
    ref = FigaroEngine(donate_data=False)
    for f, req in zip(futures, reqs):
        ri = ref.qr(plan, list(req), dtype=F64, device="cpu")
        torch.testing.assert_close(
            f.result(timeout=60), ri, rtol=0,
            atol=1e-10 * max(float(ri.abs().max()), 1.0))
    assert engine.trace_count("qr_batched") == 1
    server.close()


# -- the port's server against the JAX package's ------------------------------


def _jax_plan():
    db = jax_full_reduce(JaxDatabase.from_arrays(_star_tables()),
                         _STAR_EDGES)
    return jax_build_plan(JaxJoinTree.from_edges(db, "Orders", _STAR_EDGES))


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def _row_signs(x, ref):
    """``x`` with each row's sign matched to ``ref``'s (vectors are unique
    only up to sign)."""
    x, ref = np.asarray(x), np.asarray(ref)
    s = np.sign(np.sum(x * ref, axis=-1, keepdims=True))
    return x * np.where(s == 0, 1.0, s)


_JAX_SERVE_ENGINE = JaxEngine(donate_data=False)


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_server_matches_jax_server(kind):
    """The same four requests (two coalesced with a sub-batch of two)
    through the JAX package's server and the port's, float64: answers equal
    to 1e-9 relative."""
    rng = np.random.default_rng(7)
    jplan = _jax_plan()
    plan = build_plan(_star_tree())
    reqs = _requests(plan, rng, 4)
    subs = [reqs[0], reqs[1], _stack(reqs[2:])]
    kw = dict(kind=kind, label_col=1 if kind == "lsq" else None,
              k=3 if kind == "pca" else None)
    jserver = jax_make_figaro_server(jplan, dtype=jnp.float64,
                                     engine=_JAX_SERVE_ENGINE, **kw)
    server = make_figaro_server(plan, dtype=F64, device="cpu", **kw)
    answers = []
    for srv in (jserver, server):
        srv.pause()
        futures = [srv.submit(r) for r in subs]
        srv.resume()
        answers.append([f.result(timeout=120) for f in futures])
        srv.close()
    for want, got in zip(*answers):
        if kind == "qr":
            got = normalize_sign(got).numpy()
            want = normalize_sign(torch.tensor(np.asarray(want))).numpy()
            assert _rel(got, want) <= 1e-9
        elif kind == "svd":
            assert _rel(got[0], want[0]) <= 1e-9
            assert _rel(_row_signs(got[1], want[1]), want[1]) <= 1e-9
        elif kind == "pca":
            for f in ("explained_variance", "mean", "num_rows"):
                assert _rel(getattr(got, f), getattr(want, f)) <= 1e-9, f
            assert _rel(_row_signs(got.components, want.components),
                        want.components) <= 1e-9
        else:
            assert _rel(got[0], want[0]) <= 1e-9
            assert _rel(got[1], want[1]) <= 1e-9


# -- the engine's serving contract: donation and staging ----------------------


def test_donated_request_is_dropped_once_consumed_and_results_unchanged(
        monkeypatch, rng):
    """A donating engine empties its own list of the request's tensors once
    R has been formed (PCA's moments come before R), so nothing reads them
    again; a non-donating one keeps them to the end; plan.data is never
    donated. The answers are the same either way."""
    plan = build_plan(_star_tree())
    batch = tuple(torch.as_tensor(d) for d in _stack(_requests(plan, rng, 3)))
    seen = {}
    real_body = FigaroEngine._body
    real_tail = FigaroEngine._tail

    def body(self, kind, plan_, data, options):
        seen["data"] = data
        return real_body(self, kind, plan_, data, options)

    def tail(self, kind, r, moments, options):
        seen["left"] = len(seen["data"])
        return real_tail(self, kind, r, moments, options)

    monkeypatch.setattr(FigaroEngine, "_body", body)
    monkeypatch.setattr(FigaroEngine, "_tail", tail)
    outs = {}
    for donate in (True, False):
        eng = FigaroEngine(donate_data=donate)
        assert eng.donate_data is donate
        outs[donate] = eng.pca(plan, batch, batched=True, k=2, dtype=F64,
                               device="cpu")
        assert seen["left"] == (0 if donate else len(batch))
        eng.qr(plan, plan.data, dtype=F64, device="cpu")  # plan-owned
        assert seen["left"] == len(plan.data)
        eng.qr(plan, dtype=F64, device="cpu")
        assert seen["left"] == len(plan.data)
    for f in ("components", "explained_variance", "mean", "num_rows"):
        assert torch.equal(getattr(outs[True], f), getattr(outs[False], f))
    assert engine_mod.default_engine().donate_data is False
    assert figaro.Session(device="cpu").engine.donate_data is False


def test_session_donate_data_validation(monkeypatch):
    engine = FigaroEngine()
    with pytest.raises(ValueError, match="donate_data"):
        figaro.Session(device="cpu", engine=engine, donate_data=True)
    assert figaro.Session(device="cpu",
                          donate_data=True).engine.donate_data is True
    assert figaro.Session(device="cpu").engine.donate_data is False
    # make_figaro_server builds a donating engine of its own
    from repro_torch.train import serve as serve_mod

    made = []

    class Recorded(FigaroEngine):
        def __init__(self, **kw):
            super().__init__(**kw)
            made.append(self)

    monkeypatch.setattr(serve_mod, "FigaroEngine", Recorded)
    server = make_figaro_server(build_capacity_plan(_star_tree()),
                                device="cpu")
    assert len(made) == 1 and made[0].donate_data is True
    server.close()


def test_stage_on_the_cpu_passes_through_and_shard_takes_rank_rows(rng):
    """On the CPU nothing is staged; ``stage(shard=)`` takes this rank's
    rows of the padded batch (all of them on one rank, parts of a leaf
    concatenated) and tags them for the sharded dispatch."""
    plan = build_plan(_star_tree())
    engine = FigaroEngine()
    batch = _stack(_requests(plan, rng, 2))
    staged = engine.stage(batch, device="cpu")
    assert not isinstance(staged, Staged)
    assert all(s is d for s, d in zip(staged, batch))
    with pytest.raises(TypeError, match="DataMesh"):
        engine.stage(batch, shard=object(), device="cpu")
    mesh = make_data_mesh(device="cpu")
    parts = tuple([d[:1], d[1:]] for d in batch)
    staged = engine.stage(parts, shard=mesh)
    assert isinstance(staged, Staged) and staged.shard[1:] == (2, 2)
    for s_leaf, d in zip(staged, batch):
        assert torch.equal(s_leaf, torch.as_tensor(d))
