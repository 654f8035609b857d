"""One gloo rank of the port's distribution tests (no JAX here).

Run one process per rank::

    PYTHONPATH=src python tests/_torch_distributed_driver.py RANK WORLD STORE OUT

``tests/test_torch_distributed.py`` spawns WORLD of them. Each joins a gloo
group through the `FileStore` at STORE (every collective bounded by a 60 s
timeout), makes the data mesh over all ranks, and runs on the CPU, on the
inputs of `inputs()` (numpy, from a seed, which the test rebuilds for the
JAX package):

  * `distributed_postprocess_r0` of the star's R₀, `distributed_qr_r` of a
    [512, 12] and a [257, 9] matrix (rows not a multiple of the mesh);
  * `partitioned_figaro_qr` over the mesh with 4 partitions and with more
    partitions than the fact table has key groups;
  * the sharded batched ``qr/svd/pca/lsq`` at B = 2·P + 1 requests, a batch
    staged with ``stage(shard=)``, an empty batch, and the trace counts of
    the JAX package's sharded driver (one miss per (plan, mesh) signature,
    none for another live size in the bucket, one more for a sub-mesh);
  * servers over the mesh (`serve_over_mesh`), built on every rank through
    ``Session(mesh=).from_tree(...).serve``: rank 0 submits B = 2·P + 1
    requests for ``qr``, ``svd``, ``pca(k=3)`` and ``lsq(ridge=0.25)`` as
    sub-batches of mixed sizes while paused (one coalesced batch), checks
    that futures resolve in submission order; a poisoned request whose
    rows land on a rank ≥ 1, where that rank's local dispatch raises, fails
    only its own future; an append within capacity (``server.append``) and
    a regrowing one (``ds.append``), each followed by requests on the
    grown plan, then a re-root to D1 that every rank installs; a plan
    that differs on one rank raises `ValueError` on every rank, and that
    failed construction leaves no server thread behind; a
    follower's ``submit`` (and ``append``, ``pause``, ``resume``, its
    dataset's ``append``) raises; every follower's
    ``close`` returns after rank 0's; and while the servers live every
    collective comes from a dispatch thread.

Every rank checks that it issued no collective on a one-rank mesh, and
all-gathers its Rs (the served ones and its plan's signature too) so that
rank 0 can check them bit for bit. Rank 0 writes the results to OUT
(``.npz``). Every rank ends with no thread but its main one: no Python
thread, and, once the world's group is destroyed, no process group that
a mesh lent and no gloo worker thread (a group's threads still running
while the interpreter tears itself down can abort the rank).
"""

import datetime
import faulthandler
import pathlib
import sys
import threading
import weakref

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import (distributed_postprocess_r0,
                                          distributed_qr_r,
                                          partitioned_figaro_qr)
from repro_torch.core.engine import FigaroEngine
from repro_torch.core.figaro import figaro_r0
from repro_torch.core.join_tree import JoinTree, build_plan
from repro_torch import figaro
from repro_torch.core.plan_cache import (build_capacity_plan, plan_signature,
                                         refresh_plan)
from repro_torch.core.relation import Database, full_reduce
from repro_torch.launch.mesh import RankDispatchError, make_data_mesh
from repro_torch.train.serve import make_figaro_server

F64 = torch.float64
TIMEOUT = datetime.timedelta(seconds=60)
STAR_EDGES = [("F", "D1"), ("F", "D2")]


def star_tables(rng):
    """The star of tests/_distributed_driver.py."""
    return {
        "F": ({"a": rng.integers(0, 8, 60), "b": rng.integers(0, 5, 60)},
              rng.normal(size=(60, 3)), ["f0", "f1", "f2"]),
        "D1": ({"a": rng.integers(0, 8, 25)}, rng.normal(size=(25, 2)),
               ["d0", "d1"]),
        "D2": ({"b": rng.integers(0, 5, 18)}, rng.normal(size=(18, 2)),
               ["e0", "e1"]),
    }


MAX_WORLD = 4


def batch_size(world: int) -> int:
    """Requests of the sharded batch: a size the mesh does not divide."""
    return 2 * world + 1


def inputs(world: int):
    """(star tables, a [512, 12] and a [257, 9] matrix, a request batch of
    per-node [B, m_i, n_i] leaves at the star plan's shapes), from seed 2;
    the batch is the leading `batch_size(world)` requests of the largest."""
    rng = np.random.default_rng(2)
    tables = star_tables(rng)
    x = rng.normal(size=(512, 12))
    x_odd = rng.normal(size=(257, 9))
    plan = build_plan(star_tree(tables))
    batch = tuple(rng.normal(size=(batch_size(MAX_WORLD),)
                             + tuple(np.shape(d)))[:batch_size(world)]
                  for d in plan.data)
    return tables, x, x_odd, batch


def star_tree(tables):
    db = full_reduce(Database.from_arrays(tables), STAR_EDGES)
    return JoinTree.from_edges(db, "F", STAR_EDGES)


#: Weak references to the process groups this rank's meshes lent.
_GROUPS = []


def _watch(mesh):
    for group in (mesh.group, mesh.control):
        if isinstance(group, dist.ProcessGroup):
            _GROUPS.append(weakref.ref(group))
    return mesh


def _thread_names() -> list[str]:
    """This process's threads as the kernel names them (empty where there
    is no /proc); a thread that ends while they are read is left out."""
    task = pathlib.Path("/proc/self/task")
    names = []
    for t in sorted(task.iterdir()) if task.is_dir() else ():
        try:
            names.append((t / "comm").read_text().strip())
        except FileNotFoundError:
            pass
    return names


APPENDED = 3  # requests after each append


def appends(tree) -> list:
    """The served appends, from seed 7 over keys the star already holds:
    2 fact rows (F: 60 live rows of 64) within capacity, then 10 rows of D1
    (25 of 32), past it."""
    rng = np.random.default_rng(7)

    def rows(name, k):
        rel = tree.db[name]
        keys = {a: rel.keys[:k, i] for i, a in enumerate(rel.key_attrs)}
        return name, (keys, rng.normal(size=(k, rel.data.shape[1])))

    return [rows("F", 2), rows("D1", 10)]


def appended_requests(tree) -> list:
    """[(requests after each append)]: `APPENDED` requests at the grown
    plan's live sizes each, from seed 8 (the plans as `refresh_plan` grows
    `build_capacity_plan(tree)`)."""
    rng = np.random.default_rng(8)
    plan, out = build_capacity_plan(tree), []
    for node, rows in appends(tree):
        plan = refresh_plan(plan, {node: rows})
        live = [(int(ix.row_mask.sum()), sp.n)
                for sp, ix in zip(plan.spec.nodes, plan.index)]
        out.append([tuple(rng.normal(size=shape) for shape in live)
                    for _ in range(APPENDED)])
    return out


class _Collectives:
    """Counts this process's calls of the collectives the port uses, and
    records the thread of each."""

    NAMES = ("all_gather", "batch_isend_irecv", "broadcast", "all_reduce",
             "send", "recv", "scatter", "broadcast_object_list",
             "all_gather_object")

    def __init__(self):
        self.calls = 0
        self.threads = []
        for name in self.NAMES:
            setattr(dist, name, self._counted(getattr(dist, name)))

    def _counted(self, fn):
        def call(*args, **kwargs):
            self.calls += 1
            self.threads.append(threading.current_thread().name)
            return fn(*args, **kwargs)
        return call


def _gather_equal(mesh, t: torch.Tensor) -> bool:
    """Whether every rank holds ``t`` bit for bit."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return all(torch.equal(p, parts[0]) for p in parts)


def run(rank: int, world: int) -> dict:
    counted = _Collectives()
    mesh = _watch(make_data_mesh())
    assert mesh.size == world and mesh.rank == rank, mesh
    assert mesh.device == torch.device("cpu")
    tables, x, x_odd, batch = inputs(world)
    tree = star_tree(tables)
    plan = build_plan(tree)
    n = plan.num_cols
    b = batch_size(world)
    out = {}

    # -- the butterfly combine --------------------------------------------
    r0 = figaro_r0(plan, dtype=F64, device="cpu")
    out["r_dist"] = distributed_postprocess_r0(r0, mesh)
    out["r_qr"] = distributed_qr_r(torch.as_tensor(x), mesh)
    out["r_qr_odd"] = distributed_qr_r(torch.as_tensor(x_odd), mesh)
    out["r_part"] = partitioned_figaro_qr(tree, 4, mesh=mesh)
    m = tree.db["F"].num_rows
    out["r_part_many"] = partitioned_figaro_qr(tree, 10 * m, mesh=mesh)

    # -- sharded batched dispatch ----------------------------------------
    engine = FigaroEngine(donate_data=False)
    counts = []
    rb = engine.qr(plan, batch, batched=True, shard=mesh, dtype=F64)
    assert rb.shape == (b, n, n), rb.shape
    counts.append(engine.trace_count("qr_batched"))
    again = engine.qr(plan, batch, batched=True, shard=mesh, dtype=F64)
    staged = engine.stage(batch, shard=mesh)
    assert staged.shard[1:] == (b, -(-b // world) * world), staged.shard
    from_staged = engine.qr(plan, staged, batched=True, shard=mesh,
                            dtype=F64)
    counts.append(engine.trace_count("qr_batched"))
    # another live size in the bucket of B: no miss
    bucket = -(-b // world) * world
    fewer = engine.qr(plan, tuple(d[:b - 1] for d in batch), batched=True,
                      shard=mesh, batch_capacity=bucket, dtype=F64)
    assert torch.allclose(fewer, rb[:b - 1], rtol=0, atol=1e-12)
    counts.append(engine.trace_count("qr_batched"))
    out["stable"] = np.array([torch.equal(again, rb),
                              torch.equal(from_staged, rb)])
    empty = engine.least_squares(plan, n - 1, tuple(d[:0] for d in batch),
                                 batched=True, shard=mesh, dtype=F64)
    assert empty[0].shape == (0, n - 1) and empty[1].shape == (0,)
    if world > 1:  # a sub-mesh is another mesh signature: one more miss
        sub = _watch(make_data_mesh(world - 1, timeout=TIMEOUT))
        if sub.rank is not None:  # rank world - 1 holds no rank of it
            engine.qr(plan, batch, batched=True, shard=sub, dtype=F64)
            counts.append(engine.trace_count("qr_batched"))
    out["trace_counts"] = np.array(counts)
    out["qr_batched"] = rb
    out["svd_s"], out["svd_vt"] = engine.svd(plan, batch, batched=True,
                                             shard=mesh, dtype=F64)
    pca = engine.pca(plan, batch, batched=True, shard=mesh, k=3, dtype=F64)
    out["pca_ev"], out["pca_mean"] = pca.explained_variance, pca.mean
    out["lsq_beta"], out["lsq_resid"] = engine.least_squares(
        plan, n - 1, batch, batched=True, shard=mesh, ridge=0.25, dtype=F64)

    # -- servers over the mesh --------------------------------------------
    first = len(counted.threads)
    served, served_r = serve_over_mesh(mesh, tables, tree, batch)
    window = counted.threads[first:]
    assert set(window) <= {"figaro-serve-dispatch"}, sorted(set(window))
    out.update(served)

    out["collectives"] = np.array(counted.calls)
    if world == 1:
        assert counted.calls == 0, "a one-rank mesh issued a collective"
    else:
        sig = torch.frombuffer(bytearray.fromhex(out.pop("plan_sig")),
                               dtype=torch.uint8)
        out["bit_identical"] = np.array([
            _gather_equal(mesh, out[k]) for k in (
                "r_dist", "r_qr", "r_qr_odd", "r_part", "r_part_many",
                "qr_batched", "svd_s", "lsq_beta")] + [
            _gather_equal(mesh, served_r), _gather_equal(mesh, sig)])
    out.pop("plan_sig", None)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


SERVE_KINDS = (("qr", {}), ("svd", {}), ("pca", {"k": 3}),
               ("lsq", {"ridge": 0.25}))


def _sub_batches(batch) -> list:
    """The requests of ``batch`` as one single request, then sub-batches of
    2, 1, 3, 2, 1, ... requests."""
    b, sizes, at = len(batch[0]), [], 1
    while at < b:
        sizes.append(min((2, 1, 3)[len(sizes) % 3], b - at))
        at += sizes[-1]
    subs, at = [tuple(d[0] for d in batch)], 1
    for k in sizes:
        subs.append(tuple(d[at:at + k] for d in batch))
        at += k
    return subs


def _held_stream(server, requests) -> list:
    """Submit ``requests`` while the coalescer is held, then release it;
    every answer as [b, ...] parts, and whether the futures resolved in
    submission order."""
    order = []
    server.pause()
    futures = [server.submit(r) for r in requests]
    for i, f in enumerate(futures):
        f.add_done_callback(lambda _, i=i: order.append(i))
    server.resume()
    answers = [f.result(timeout=120) for f in futures]
    assert order == list(range(len(futures))), order
    return answers


def _stacked(answers, single_first: bool):
    """Per-request answers [B, ...] from a stream's parts (a tensor, a
    tuple of them, or a PCAResult)."""
    from repro_torch.core.engine import map_result

    if single_first:
        answers = [map_result(lambda x: x[None], answers[0])] + answers[1:]
    first = answers[0]
    if isinstance(first, tuple):
        return tuple(torch.cat([a[j] for a in answers])
                     for j in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.cat(answers)
    return {f: torch.cat([getattr(a, f) for a in answers])
            for f in ("explained_variance", "mean")}


def serve_over_mesh(mesh, tables, tree, batch):
    """Every rank builds each server; rank 0 drives the checks (module
    docstring). Returns rank 0's answers (and every rank's plan signature
    and the served Rs, recorded on each rank, for the bit-for-bit check)."""
    rank, world = mesh.rank, mesh.size
    n = build_plan(tree).num_cols
    sess = figaro.Session(mesh=mesh, device="cpu")
    ds = sess.from_tree(tree)
    out, served_r = {}, []
    for kind, kw in SERVE_KINDS:
        if kind == "lsq":
            kw = dict(kw, label_col=n - 1)
        if kind == "qr":
            # A rank's dispatch thread follows rank 0's stream from the
            # moment its constructor returns, so its hooks go in first.
            _hook_qr(sess.engine, rank, served_r)
        server = ds.serve(kind, dtype=F64, **kw)
        if rank != 0:
            _check_follower(server, ds)
            server.close()  # returns once rank 0 has closed
            _follow_appends(ds, kind)
            continue
        got = _stacked(_held_stream(server, _sub_batches(batch)), True)
        if kind == "qr":
            out["served_qr"] = got
            out["poison"] = _poisoned_stream(server, batch, got)
            _unhook_qr(sess.engine)
        elif kind == "svd":
            out["served_svd_s"], out["served_svd_vt"] = got
        elif kind == "pca":
            out["served_pca_ev"] = got["explained_variance"]
            out["served_pca_mean"] = got["mean"]
        else:
            out["served_lsq_beta"], out["served_lsq_resid"] = got
            out.update(_served_appends(server, ds, tree))
        server.close()
    if world > 1:
        _check_plan_mismatch(mesh, tables, rank)
    out["plan_sig"] = plan_signature(ds.plan)
    return out, torch.cat(served_r)


def _poisoned_stream(server, batch, clean):
    """tests/test_async_serve.py:197 across ranks: the last request carries
    NaNs, which a rank ≥ 1's local dispatch refuses (`_follow_poison`
    patches it there); its batchmates are answered (each re-sent alone),
    and only its future fails, naming that rank."""
    requests = [tuple(d[i] for d in batch) for i in range(len(batch[0]))]
    requests[-1] = tuple(np.full_like(d, np.nan) for d in requests[-1])
    server.pause()
    futures = [server.submit(r) for r in requests]
    server.resume()
    for i, f in enumerate(futures[:-1]):
        assert torch.allclose(f.result(timeout=120), clean[i],
                              rtol=1e-12, atol=1e-12), i
    err = futures[-1].exception(timeout=120)
    world = server._link.mesh.size if server._link is not None else 1
    if world == 1:  # no rank ≥ 1: NaN rows answer NaN
        assert err is None
        return np.array([1])
    assert isinstance(err, RankDispatchError) and err.rank >= 1, err
    assert "poisoned rows" in err.message, err.message
    return np.array([err.rank])


def _check_follower(server, ds):
    """A follower's surface: requests and plan changes are rank 0's."""
    for call in (lambda: server.submit(()), lambda: server(()),
                 lambda: server.append("F", None), server.pause,
                 server.resume, lambda: ds.append("F", {}, np.zeros((0, 3)))):
        try:
            call()
        except RuntimeError as e:
            assert "rank 0" in str(e), e
        else:
            raise AssertionError("a follower must refuse requests")


def _hook_qr(engine, rank, served_r):
    """Before the qr server is built: record in ``served_r`` the R of every
    ``engine.qr`` dispatch (every rank's dispatch thread runs one per batch),
    and on a rank ≥ 1 make the local dispatch raise on NaN rows (rank 0's
    poisoned batch, `_poisoned_stream`)."""
    qr, run = engine.qr, engine._run

    def recorded(*args, **kwargs):
        r = qr(*args, **kwargs)
        served_r.append(r)
        return r

    def poisoned(kind, plan, data, *args, **kwargs):
        if any(bool(torch.isnan(d).any()) for d in data):
            raise RuntimeError(f"poisoned rows on rank {rank}")
        return run(kind, plan, data, *args, **kwargs)

    engine.qr = recorded
    if rank != 0:
        engine._run = poisoned


def _unhook_qr(engine):
    """Drop `_hook_qr`'s wrappers once the qr server has closed."""
    vars(engine).pop("qr", None)
    vars(engine).pop("_run", None)


def _served_appends(server, ds, tree):
    """Rank 0: an append within capacity through the server, requests, a
    regrowing one through the dataset, requests, and a re-root (what an
    adaptive dataset's append decides) that the stream carries."""
    out = {}
    (node1, rows1), (node2, rows2) = appends(tree)
    after = appended_requests(tree)
    assert server.append(node1, rows1) is True
    got = _stacked(_held_stream(server, [tuple(d[None] for d in r)
                                         for r in after[0]]), False)
    out["appended1_beta"], out["appended1_resid"] = got
    assert ds.append(node2, *rows2) is False  # a regrow
    got = _stacked(_held_stream(server, [tuple(d[None] for d in r)
                                         for r in after[1]]), False)
    out["appended2_beta"], out["appended2_resid"] = got
    ds._reroot_to("D1")  # a re-root rank 0 decided: every rank installs it
    return out


def _follow_appends(ds, kind):
    """A follower's dataset after a server closed: the qr hooks are gone,
    and after rank 0's lsq server both appends and the re-root came
    through the stream."""
    if kind == "qr":
        _unhook_qr(ds._session.engine)
    if kind == "lsq":
        stats = ds.stats()
        assert (stats["appends"], stats["regrows"], stats["reroots"],
                stats["root"]) == (2, 1, 1, "D1"), stats


def _check_plan_mismatch(mesh, tables, rank):
    """A plan from other tables on the last rank: `ValueError` on every
    rank, from the construction's check."""
    t = dict(tables)
    if rank == mesh.size - 1:
        keys, data, names = t["F"]
        t["F"] = ({a: v[:-1] for a, v in keys.items()}, data[:-1], names)
    try:
        make_figaro_server(build_capacity_plan(star_tree(t)), kind="qr",
                           dtype=F64, mesh=mesh, device="cpu")
    except ValueError as e:
        assert f"rank {mesh.size - 1}: plan" in str(e), e
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("figaro-serve")]
        assert not left, f"a failed construction left threads: {left}"
    else:
        raise AssertionError("a plan mismatch must raise on every rank")


def main(argv) -> None:
    rank, world, store_path, out_path = (int(argv[1]), int(argv[2]),
                                         argv[3], argv[4])
    faulthandler.enable(all_threads=True)  # an abort shows every thread
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        results = run(rank, world)
        if rank == 0:
            np.savez(out_path, **results)
    finally:
        dist.destroy_process_group()
    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread()]
    assert not left, f"threads left at exit: {left}"
    alive = sum(ref() is not None for ref in _GROUPS)
    assert not alive, f"{alive} process group(s) outlived their destruction"
    # a destroyed group has joined its worker threads (its transport's
    # event loop may still be winding down on its own)
    workers = [name for name in _thread_names() if "gloo_runloop" in name]
    assert not workers, f"gloo worker threads left at exit: {workers}"
    print(f"RANK-OK {rank}/{world}", flush=True)


if __name__ == "__main__":
    main(sys.argv)
