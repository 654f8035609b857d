"""The port's runtime sanitizer (`repro_torch.sanitizer`) on the port's engine.

Mirrors tests/test_sanitizer.py: enable/disable semantics, lock-order cycle
detection, rlock re-entrancy, the lockset race detector (on fixtures and on
the port's `FigaroEngine` and `PlanHolder` under two threads), a thread
exiting with a lock held, retrace attribution naming the diverged component
of the port's signature, shadow dispatches neither counting nor retracing,
the float32 error within the paper's database-size budget (the same budget
as the JAX package's on the same plan), the NaN tripwire and sampling,
and the two async-server storms of tests/test_sanitizer_stress.py on the
port's server. It also holds every lock and thread of `repro_torch` to the sanitizer's
wrappers through the port's lint rule FGT007: no raw
``threading.Lock/RLock/Condition/Thread`` outside ``sanitizer/``. The port
runs on the CPU.
"""

import pathlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sanitizer as jsanitizer
from repro.core.engine import FigaroEngine as JaxEngine
from repro.core.join_tree import build_plan as jax_build_plan
from repro.data import relational as jrel
from repro.sanitizer import numerics as jnumerics
from repro_torch import sanitizer
from repro_torch.analysis import analyze_paths, analyze_source
from repro_torch.analysis.rules import SanRoutingRule
from repro_torch.core.engine import FigaroEngine
from repro_torch.core.join_tree import build_plan
from repro_torch.core.plan_cache import PlanHolder, build_capacity_plan
from repro_torch.data import relational as trel
from repro_torch.data.relational import retailer_like
from repro_torch.sanitizer import numerics as san_numerics
from repro_torch.sanitizer import retrace as san_retrace
from repro_torch.sanitizer.locks import san_lock, san_rlock
from repro_torch.sanitizer.races import shared_state
from repro_torch.sanitizer.threads import san_thread

PORT = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"


@pytest.fixture
def san():
    """The port's sanitizer armed for one test, fully torn down after."""
    sanitizer.enable(sample_every=1)
    sanitizer.reset()
    yield sanitizer
    sanitizer.reset()
    sanitizer.disable()


def _run_threads(*targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)


def _qr(engine, plan, data=None, dtype=torch.float32):
    return engine.qr(plan, data, dtype=dtype, device="cpu")


# -- enable / disable ---------------------------------------------------------


def test_disabled_by_default_and_hooks_physically_removed():
    assert not sanitizer.enabled()
    assert "__getattribute__" not in PlanHolder.__dict__
    assert "__getattribute__" not in FigaroEngine.__dict__
    sanitizer.enable()
    try:
        assert sanitizer.enabled() and not jsanitizer.enabled()
        assert "__getattribute__" in PlanHolder.__dict__
        assert "__getattribute__" in FigaroEngine.__dict__
    finally:
        sanitizer.disable()
    assert "__getattribute__" not in PlanHolder.__dict__


def test_report_empty_and_grouped(san):
    assert "no findings" in san.report()
    sanitizer.STATE.add_finding("race", "synthetic", details={})
    assert "race" in san.report() and "synthetic" in san.report()


# -- lock-order cycles --------------------------------------------------------


def test_lock_order_cycle_flagged_on_synthetic_deadlock(san):
    a, b = san_lock("fixture.A"), san_lock("fixture.B")
    with a:
        with b:
            pass
    assert san.findings("lock-order") == []
    with b:
        with a:
            pass
    msgs = [f.message for f in san.findings("lock-order")]
    assert any("lock acquisition cycle (potential deadlock)" in m
               and "fixture.A" in m and "fixture.B" in m for m in msgs)


def test_consistent_lock_order_is_quiet(san):
    a, b = san_lock("fixture.C"), san_lock("fixture.D")
    for _ in range(3):
        with a:
            with b:
                pass
    assert san.findings("lock-order") == []


def test_rlock_reentrancy_is_not_a_self_cycle(san):
    r = san_rlock("fixture.R")
    with r:
        with r:
            pass
    assert san.findings("lock-order") == []


# -- lockset race detection ---------------------------------------------------


def _bad_counter_cls():
    @shared_state({"counter": "_lock"})
    class Bad:
        def __init__(self):
            self._lock = san_lock("bad._lock")
            self.counter = 0

        def bump_locked(self):
            with self._lock:
                self.counter += 1

        def read_unlocked(self):
            return self.counter

    return Bad


def test_race_detector_flags_unlocked_cross_thread_read(san):
    bad = _bad_counter_cls()()
    bad.bump_locked()  # observed from the constructing thread first
    _run_threads(bad.read_unlocked)
    msgs = [f.message for f in san.findings("race")]
    assert any("Bad.counter read from a second thread without _lock held"
               in m for m in msgs)


def test_single_threaded_unlocked_access_is_not_a_race(san):
    bad = _bad_counter_cls()()
    for _ in range(5):
        bad.read_unlocked()
    assert san.findings("race") == []


def test_engine_and_plan_holder_clean_under_two_threads(san):
    """Two threads dispatch one signature through one port engine while
    hammering a `PlanHolder`: no race and no lock-order finding, one miss,
    both answers equal to a lone dispatch's."""
    sanitizer.STATE.numerics = False
    plan = build_plan(retailer_like(scale=20, cols=2))
    engine = FigaroEngine()
    holder = PlanHolder(build_capacity_plan(retailer_like(scale=20, cols=2)))
    want = _qr(FigaroEngine(), plan, dtype=torch.float64)
    got = []

    def worker():
        for _ in range(3):
            got.append(_qr(engine, plan, dtype=torch.float64))
        for _ in range(50):
            holder.note_external_append("Inventory", 1)
            holder.counters()

    _run_threads(worker, worker)
    assert len(got) == 6 and all(torch.equal(r, want) for r in got)
    assert engine.trace_count("qr") == 1 and engine.cache_size() == 1
    assert holder.counters()[0] == 100  # 2 threads x 50, none lost
    assert holder.append_volumes() == {"Inventory": 100}
    assert san.findings("race") == []
    assert san.findings("lock-order") == []


def test_thread_exit_holding_lock_flagged(san):
    lock = san_lock("fixture.leak")

    def leaky():
        lock.acquire()

    t = san_thread(leaky)
    t.start()
    t.join(timeout=10.0)
    msgs = [f.message for f in san.findings("thread")]
    assert any("exited holding lock" in m and "fixture.leak" in m
               for m in msgs)


# -- retrace attribution ------------------------------------------------------


def test_retrace_attribution_names_diverged_component(san):
    """The port's signature is (kind, device, plan spec, mask layout, data
    shapes and dtypes, options, mesh): a new dtype changes the data's dtype
    and the options, a different plan the spec (and the data shapes)."""
    sanitizer.STATE.numerics = False
    plan = build_plan(retailer_like(scale=20, cols=2))
    engine = FigaroEngine()
    _qr(engine, plan)
    _qr(engine, plan)  # cache hit: no event
    events = [e for e in san_retrace.events() if e.kind == "qr"]
    assert len(events) == 1 and events[0].diverged == []
    assert san.findings("retrace") == []  # warm-up misses are not findings

    sanitizer.expect_no_retrace()
    _qr(engine, plan)  # steady state: still cached
    assert san.findings("retrace") == []
    _qr(engine, plan, dtype=torch.float64)
    msgs = [f.message for f in san.findings("retrace")]
    assert any("retrace of kind=qr" in m and "options" in m for m in msgs)
    assert san_retrace.last_trace("qr").diverged == ["data_abstract",
                                                     "options"]
    _qr(engine, build_plan(retailer_like(scale=40, cols=2)),
        dtype=torch.float64)
    assert san_retrace.last_trace("qr").diverged == ["plan_spec",
                                                     "data_abstract"]
    assert san_retrace.KEY_COMPONENTS == (
        "kind", "device", "plan_spec", "mask_layout", "data_abstract",
        "options", "mesh")


def test_shadow_dispatches_do_not_bump_or_retrace(san):
    plan = build_plan(retailer_like(scale=20, cols=2))
    engine = FigaroEngine()
    _qr(engine, plan)  # sampled: shadows through float64, eagerly
    assert san_numerics.events(), "first dispatch must be shadow-sampled"
    assert engine.trace_count() == 1 and engine.cache_size() == 1
    assert all(ev.kind == "qr" for ev in san_retrace.events())
    assert len(san_retrace.events()) == 1


# -- numerics: the paper's database-size error budget -------------------------


@pytest.mark.parametrize("name", ["retailer", "yelp"])
def test_f32_error_within_database_size_budget(san, name):
    """rel_err(float32 vs the float64 shadow) <= eps(float32) · slack ·
    database rows, the same budget the JAX package's sanitizer sets on the
    same plan."""
    make = {"retailer": lambda m: m.retailer_like(scale=60, cols=2),
            "yelp": lambda m: m.yelp_like(scale=40, cols=2)}[name]
    plan = build_plan(make(trel))
    engine = FigaroEngine()
    _qr(engine, plan)
    events = [e for e in san_numerics.events() if e["kind"] == "qr"]
    assert len(events) == 1
    ev = events[0]
    db_rows = san_numerics.database_rows(tuple(plan.data), plan)
    assert ev["db_rows"] == db_rows and ev["dtype"] == "float32"
    assert ev["budget"] == pytest.approx(
        float(np.finfo(np.float32).eps) * sanitizer.STATE.numerics_slack
        * db_rows)
    assert 0.0 <= ev["rel_err"] <= ev["budget"]
    assert san.findings("numerics") == []

    jplan = jax_build_plan(make(jrel))
    assert jnumerics.database_rows(tuple(jplan.data), jplan) == db_rows
    assert jnumerics.error_budget(np.dtype(np.float32), db_rows) \
        == pytest.approx(ev["budget"])


def test_nan_input_trips_nonfinite_tripwire(san):
    plan = build_plan(retailer_like(scale=20, cols=2))
    engine = FigaroEngine()
    data = [np.array(d, dtype=np.float64, copy=True) for d in plan.data]
    data[0][0, 0] = np.nan
    _qr(engine, plan, tuple(data))
    msgs = [f.message for f in san.findings("numerics")]
    assert any("non-finite" in m and "kind=qr" in m for m in msgs)


def test_nonfinite_tripwire_walks_tuples_and_pca_results(san):
    """The tripwire reads every floating tensor of a tuple result (svd,
    lsq) and of a `PCAResult`, and skips integer ones. (torch's eigh and
    svd raise on a non-finite matrix, where jnp's return NaN, so the
    results are built here.)"""
    from repro_torch.core.engine import PCAResult

    ok = torch.ones(3, dtype=torch.float64)
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    san_numerics._check_finite("svd", (ok, bad))
    san_numerics._check_finite("pca", PCAResult(ok[None], ok, bad,
                                                torch.tensor(3.0)))
    san_numerics._check_finite("qr", torch.arange(3))
    msgs = [f.message for f in san.findings("numerics")]
    assert any("kind=svd output leaf 1 (2/3 entries)" in m for m in msgs)
    assert any("kind=pca output leaf 2 (2/3 entries)" in m for m in msgs)
    assert not any("kind=qr" in m for m in msgs)


def test_numerics_sampling_skips_unsampled_dispatches(san):
    sanitizer.STATE.sample_every = 1000
    plan = build_plan(retailer_like(scale=20, cols=2))
    engine = FigaroEngine()
    _qr(engine, plan)  # first dispatch always shadows
    _qr(engine, plan)  # 2nd of 1000: not sampled
    assert len([e for e in san_numerics.events() if e["kind"] == "qr"]) == 1


def test_float64_dispatches_are_not_shadowed(san):
    plan = build_plan(retailer_like(scale=20, cols=2))
    _qr(FigaroEngine(), plan, dtype=torch.float64)
    assert san_numerics.events() == []


def test_jax_budget_on_the_same_dispatch_matches():
    """The JAX package's sanitizer, armed alone, records the same database
    size and budget for the same plan; the port's stays off meanwhile."""
    jsanitizer.enable(sample_every=1)
    jsanitizer.reset()
    try:
        jplan = jax_build_plan(jrel.retailer_like(scale=20, cols=2))
        JaxEngine(donate_data=False).qr(jplan, dtype=jnp.float32)
        (ev,) = [e for e in jnumerics.events() if e["kind"] == "qr"]
        assert not sanitizer.enabled() and san_numerics.events() == []
    finally:
        jsanitizer.reset()
        jsanitizer.disable()
    plan = build_plan(retailer_like(scale=20, cols=2))
    assert san_numerics.database_rows(tuple(plan.data), plan) \
        == ev["db_rows"]
    assert san_numerics.error_budget(torch.float32, ev["db_rows"]) \
        == pytest.approx(ev["budget"])


# -- routing: every lock and thread of the port goes through the wrappers ----


# -- the async server under the sanitizer (tests/test_sanitizer_stress.py) ------

N_SUBMITTERS = 3
SUBMITS_PER_THREAD = 5
N_APPENDS = 3
N_STATS_READERS = 2


def _star_ds(session):
    rng = np.random.default_rng(7)
    tables = {
        "Orders": ({"cust": np.arange(20) % 8, "prod": np.arange(20) % 4},
                   rng.normal(size=(20, 2)), ["amount", "qty"]),
        "Customers": ({"cust": np.arange(8)},
                      rng.normal(size=(8, 2)), ["age", "income"]),
        "Products": ({"prod": np.arange(4)},
                     rng.normal(size=(4, 1)), ["price"]),
    }
    return session.ingest(tables).join(
        "Orders", [("Orders", "Customers"), ("Orders", "Products")])


def test_threaded_submit_append_stats_zero_findings(san):
    """Several threads hammer one port `AsyncFigaroServer` with interleaved
    submit / append / stats under the armed sanitizer (retrace tripwire on
    after warming every batch bucket): no finding, every future resolves,
    and each thread's futures resolve in its submission order."""
    from repro_torch import figaro

    sess = figaro.Session(headroom=16, device="cpu")
    ds = _star_ds(sess)
    server = ds.serve(kind="qr", dtype=torch.float64, max_batch=4)
    # Warm every batch bucket the storm can coalesce into (capacities 1, 2
    # and 4 with max_batch=4), THEN arm the retrace tripwire.
    warm = lambda: tuple(np.asarray(d) for d in ds.plan.data)
    for group in (1, 2, 3):
        server.pause()
        futs = [server.submit(warm()) for _ in range(group)]
        server.resume()
        for f in futs:
            f.result(timeout=120)
    sanitizer.expect_no_retrace()

    resolved = []  # (submitter_id, seq), appended in resolution order
    resolved_lock = threading.Lock()
    errors = []

    def record(tid, seq):
        def cb(fut):
            with resolved_lock:
                resolved.append((tid, seq))
        return cb

    n = ds.plan.num_cols

    def submitter(tid):
        rng = np.random.default_rng(tid)
        try:
            futures = []
            for seq in range(SUBMITS_PER_THREAD):
                req = tuple(rng.normal(size=np.shape(d))
                            for d in ds.plan.data)
                fut = server.submit(req)
                fut.add_done_callback(record(tid, seq))
                futures.append(fut)
            for fut in futures:
                assert fut.result(timeout=120).shape == (n, n)
        except BaseException as e:  # surfaced after the join below
            errors.append(e)

    def appender():
        try:
            for step in range(N_APPENDS):
                in_cap = server.append(
                    "Orders", ({"cust": np.array([step]),
                                "prod": np.array([step % 4])},
                               np.ones((1, 2)) * step))
                assert in_cap, "append within headroom must stay in capacity"
        except BaseException as e:
            errors.append(e)

    def stats_reader():
        try:
            for _ in range(20):
                st = ds.stats()
                assert st["nodes"]["Orders"]["live_rows"] >= 20
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(tid,))
               for tid in range(N_SUBMITTERS)]
    threads.append(threading.Thread(target=appender))
    threads += [threading.Thread(target=stats_reader)
                for _ in range(N_STATS_READERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    assert not any(t.is_alive() for t in threads), "stress thread hung"
    assert errors == [], errors

    server.flush()
    server.close()
    with resolved_lock:
        done = list(resolved)
    assert len(done) == N_SUBMITTERS * SUBMITS_PER_THREAD
    for tid in range(N_SUBMITTERS):
        seqs = [seq for t, seq in done if t == tid]
        assert seqs == sorted(seqs), \
            f"thread {tid} futures resolved out of submission order: {seqs}"
    assert sanitizer.findings() == [], "\n" + sanitizer.report()
    st = ds.stats()
    assert st["appends"] == N_APPENDS and st["regrows"] == 0


def test_two_servers_one_holder_under_sanitizer(san):
    """Sibling servers share the PlanHolder; appends through one stay
    race-free and visible through the other while both dispatch."""
    from repro_torch import figaro

    sess = figaro.Session(headroom=16, device="cpu")
    ds = _star_ds(sess)
    s1 = ds.serve(kind="qr", dtype=torch.float64)
    s2 = ds.serve(kind="qr", dtype=torch.float64)
    req = lambda: tuple(np.asarray(d) for d in ds.plan.data)

    def pump(server):
        for _ in range(3):
            server.submit(req()).result(timeout=120)

    t1 = threading.Thread(target=pump, args=(s1,))
    t2 = threading.Thread(target=pump, args=(s2,))
    t1.start()
    t2.start()
    t1.join(timeout=300.0)
    t2.join(timeout=300.0)
    assert not t1.is_alive() and not t2.is_alive()
    assert s1.append("Orders", ({"cust": np.array([0]),
                                 "prod": np.array([0])}, np.ones((1, 2))))
    assert ds.plan is s2.plan, "holder forked between sibling servers"
    s1.close()
    s2.close()
    assert sanitizer.findings() == [], "\n" + sanitizer.report()


def test_port_routes_locks_and_threads_through_the_sanitizer():
    """The port's lint rule FGT007 over the port finds no raw
    `threading.Lock/RLock/Condition/Thread` outside `sanitizer/`."""
    findings = analyze_paths([str(PORT)], rules=[SanRoutingRule()],
                             root=str(PORT.parent.parent))
    assert not findings, [f.render() for f in findings]
    # the rule sees what it should
    probe = analyze_source("import threading\nx = threading.Lock()\n"
                           "from threading import Thread\n",
                           "src/repro_torch/probe.py", [SanRoutingRule()])
    assert sorted(f.message.split("`")[1] for f in probe) == [
        "threading.Lock", "threading.Thread"]
