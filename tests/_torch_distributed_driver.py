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
  * a server over the mesh: it serves on one rank and raises
    `NotImplementedError` naming A12.2 on more.

Every rank checks that it issued no collective on a one-rank mesh, and
all-gathers its Rs so that rank 0 can check them bit for bit. Rank 0 writes
the results to OUT (``.npz``).
"""

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import (distributed_postprocess_r0,
                                          distributed_qr_r,
                                          partitioned_figaro_qr)
from repro_torch.core.engine import FigaroEngine
from repro_torch.core.figaro import figaro_r0
from repro_torch.core.join_tree import JoinTree, build_plan
from repro_torch.core.relation import Database, full_reduce
from repro_torch.launch.mesh import make_data_mesh
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


class _Collectives:
    """Counts this process's calls of the collectives the port uses."""

    def __init__(self):
        self.calls = 0
        for name in ("all_gather", "batch_isend_irecv", "broadcast",
                     "all_reduce", "send", "recv"):
            setattr(dist, name, self._counted(getattr(dist, name)))

    def _counted(self, fn):
        def call(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        return call


def _gather_equal(mesh, t: torch.Tensor) -> bool:
    """Whether every rank holds ``t`` bit for bit."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return all(torch.equal(p, parts[0]) for p in parts)


def run(rank: int, world: int) -> dict:
    counted = _Collectives()
    mesh = make_data_mesh()
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
        sub = make_data_mesh(world - 1, timeout=TIMEOUT)
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

    # -- a server over the mesh ------------------------------------------
    def server():
        return make_figaro_server(plan, kind="lsq", label_col=n - 1,
                                  ridge=0.25, dtype=F64, engine=engine,
                                  mesh=mesh, device="cpu")

    if world == 1:
        serve = server()
        out["served_beta"], out["served_resid"] = serve(batch)
        serve.close()
    else:
        try:
            server()
        except NotImplementedError as e:
            assert "A12.2" in str(e), e
        else:
            raise AssertionError("a server over several ranks must raise")

    out["collectives"] = np.array(counted.calls)
    if world == 1:
        assert counted.calls == 0, "a one-rank mesh issued a collective"
    else:
        out["bit_identical"] = np.array([
            _gather_equal(mesh, out[k]) for k in (
                "r_dist", "r_qr", "r_qr_odd", "r_part", "r_part_many",
                "qr_batched", "svd_s", "lsq_beta")])
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def main(argv) -> None:
    rank, world, store_path, out_path = (int(argv[1]), int(argv[2]),
                                         argv[3], argv[4])
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
    print(f"RANK-OK {rank}/{world}")


if __name__ == "__main__":
    main(sys.argv)
