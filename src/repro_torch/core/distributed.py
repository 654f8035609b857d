"""Distributed FiGaRo on `torch.distributed`: the TSQR combine across a data
mesh, and fact-partitioned QR.

The port of the JAX package's ``core/distributed.py``, function by function.
A mesh (`repro_torch.launch.mesh.DataMesh`) has one rank per device and one
process per rank; every function here is called by every rank of the mesh
with the same arguments (SPMD), and every rank returns the same R.

1. **Mesh post-processing** (`distributed_postprocess_r0`): R₀'s rows are
   split over the mesh; each rank factors its block with a blocked
   Householder QR, then `butterfly_qr_combine` exchanges the N×N factors
   (log₂ P rounds of a QR of two stacked triangles) until every rank holds
   the final R — THIN's per-thread reduction and parallel combine (§7).
2. **Fact-table domain partitioning** (`partitioned_figaro_qr`, §8 Exp 2):
   the join is a disjoint union over partitions of the root relation's rows
   (key groups kept whole, the other relations replicated and reduced), so
   ``R = combine(R_1..R_k)``. Each partition runs the whole pipeline through
   the shared engine; with a mesh, partition i runs on rank ``i % P``.

Exchanges are point-to-point (`torch.distributed.batch_isend_irecv`, the
counterpart of ``ppermute``) and `all_gather`; a rank posts them only in the
rounds it takes part in, never to itself, and a mesh of one rank issues no
collective at all. Every R factor exchanged is N×N in the dispatch's dtype.

Any composition of orthogonal reductions gives the same R up to row signs,
so results are compared after `normalize_sign`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import resolve_shard

from .join_tree import JoinTree, build_plan
from .postprocess import blocked_qr_r, householder_qr_r, normalize_sign, tsqr_r
from .relation import Database, Relation, full_reduce

__all__ = [
    "butterfly_qr_combine",
    "distributed_postprocess_r0",
    "distributed_qr_r",
    "partition_fact_table",
    "partitioned_figaro_qr",
]


def _exchange(mesh, *, send=None, to=None, like=None, frm=None):
    """Post this rank's send of ``send`` to axis place ``to`` and receive
    from ``frm`` into a buffer shaped ``like``, as one batch; wait for
    both. Returns the received tensor (None when nothing is received)."""
    import torch.distributed as dist

    me = mesh.local_rank()
    ops, buf = [], None
    if send is not None:
        if to == me:
            raise RuntimeError(f"rank {me} would send to itself")
        ops.append(dist.P2POp(dist.isend, send.contiguous(), mesh.ranks[to],
                              mesh.group))
    if like is not None:
        if frm == me:
            raise RuntimeError(f"rank {me} would receive from itself")
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[frm], mesh.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf


def butterfly_qr_combine(r_local: torch.Tensor, mesh,
                         leaf_qr=householder_qr_r) -> torch.Tensor:
    """Combine every rank's N×N R factor so that each rank holds the R of
    their stack, bitwise identical on every rank.

    For a power-of-two axis: log₂ P rounds; in round d each rank stacks its
    R with that of rank ``idx ^ d`` (the lower rank's first, so both
    partners factor the same matrix) and re-triangularizes the [2N, N]
    stack. For any other P the remainder ranks [P₂, P) (P₂ the largest power
    of two ≤ P) first fold into ranks [0, P − P₂), the butterfly runs on
    [0, P₂), and the result goes back to the folded ranks. One rank returns
    ``r_local`` as it is."""
    p = mesh.size
    if p == 1:
        return r_local
    idx = mesh.local_rank()
    r = r_local
    core = 1 << (p.bit_length() - 1)  # largest power of two <= P
    rem = p - core
    if rem:  # fold ranks [core, P) into [0, rem)
        if idx >= core:
            _exchange(mesh, send=r, to=idx - core)
        elif idx < rem:
            r_in = _exchange(mesh, like=r, frm=core + idx)
            r = leaf_qr(torch.cat([r, r_in]))
    d = 1
    while d < core:
        if idx < core:
            partner = idx ^ d
            other = _exchange(mesh, send=r, to=partner, like=r, frm=partner)
            lo, hi = (r, other) if idx < partner else (other, r)
            r = leaf_qr(torch.cat([lo, hi]))
        d *= 2
    if rem:  # the combined R back to the folded ranks
        if idx < rem:
            _exchange(mesh, send=r, to=core + idx)
        elif idx >= core:
            r = _exchange(mesh, like=r, frm=idx - core)
    return r


def distributed_postprocess_r0(r0: torch.Tensor, mesh, axis: str = "data",
                               *, panel: int = 32,
                               use_kernel: bool = False) -> torch.Tensor:
    """R₀ (M×N, the same on every rank) → R (N×N) with its rows split over
    ``mesh[axis]``: rows zero-padded to a multiple of P, rank r factors
    block r (`blocked_qr_r`; ``use_kernel`` puts its panels on the
    `panel_qr` kernel), then `butterfly_qr_combine`. Runs on the mesh's
    device for this rank."""
    mesh, axis = resolve_shard(mesh, axis)
    r0 = torch.as_tensor(r0)
    m, n = r0.shape
    p = mesh.size
    rows = -(-m // p)
    lo = mesh.local_rank() * rows
    block = r0[lo:lo + rows].to(mesh.device)
    if block.shape[0] < rows:  # zero rows leave R unchanged
        block = torch.cat([block, block.new_zeros((rows - block.shape[0],
                                                   n))])
    r_local = blocked_qr_r(block, panel=panel, use_kernel=use_kernel)
    return normalize_sign(butterfly_qr_combine(r_local, mesh))


def distributed_qr_r(a: torch.Tensor, mesh, axis: str = "data",
                     **kw) -> torch.Tensor:
    """General tall-skinny distributed QR."""
    return distributed_postprocess_r0(a, mesh, axis, **kw)


# ---------------------------------------------------------------------------
# Fact-table domain partitioning.
# ---------------------------------------------------------------------------


def partition_fact_table(tree: JoinTree, num_parts: int) -> list[JoinTree]:
    """Split the root relation's rows into ``num_parts`` contiguous chunks
    (whole key groups; paper §8 Exp 2 'domain parallelism'), replicating the
    other relations. Empty chunks are dropped."""
    db = tree.db
    root = db[tree.root]
    # Root must be grouped by its sort order for contiguous whole groups;
    # sort exactly as build_plan would (no parent => canonical key order).
    root_sorted = root.sorted_by(root.key_attrs)
    m = root_sorted.num_rows
    if root.key_attrs:
        codes = np.zeros(m, dtype=np.int64)
        for a in root.key_attrs:
            codes = codes * (int(root_sorted.key_col(a).max()) + 1) + \
                root_sorted.key_col(a)
        boundaries = np.nonzero(np.r_[True, codes[1:] != codes[:-1]])[0]
    else:
        boundaries = np.arange(m)
    # Cut at group starts nearest to equal row counts.
    cuts = [0]
    for k in range(1, num_parts):
        target = k * m // num_parts
        j = int(boundaries[np.searchsorted(boundaries, target)]) \
            if target <= boundaries[-1] else m
        cuts.append(max(j, cuts[-1]))
    cuts.append(m)
    trees = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        part = Relation(root.name, root.key_attrs, root.data_attrs,
                        root_sorted.keys[lo:hi], root_sorted.data[lo:hi])
        rels = dict(db.relations)
        rels[root.name] = part
        # Dimension rows that no longer join with this fact chunk must be
        # dropped (full reduction per partition).
        sub_db = full_reduce(Database(rels), tree.edges())
        trees.append(JoinTree(sub_db, dict(tree.parent)))
    return trees


def partitioned_figaro_qr(tree: JoinTree, num_parts: int, *,
                          dtype=torch.float64, method: str = "tsqr",
                          use_kernel: bool = False, assembly: str = "padded",
                          engine=None, mesh=None, axis: str = "data",
                          device=None) -> torch.Tensor:
    """FiGaRo over ``num_parts`` fact partitions + TSQR combine.

    Each partition dispatches through the shared `FigaroEngine` (default:
    the default session's, so partitions share its cache with the rest of
    the façade), whose cache keys on the partition's plan signature: a
    repeat call replays the partitions' captured graphs.
    `Session.partitioned_qr` is the façade form.

    Without a ``mesh`` every partition runs on ``device`` (default: the
    card) and the partial R factors are TSQR-combined there. With a mesh,
    partition i runs on rank ``i % P`` (on the mesh's device for that
    rank), every rank gathers the N×N partial Rs in partition order, and
    `distributed_postprocess_r0` combines their stack across the mesh.
    """
    if mesh is None:
        device = resolve_device(device)
    else:
        mesh, axis = resolve_shard(mesh, axis)
        device = mesh.check_device(device)
    if engine is None:
        from repro_torch.api import default_session

        engine = default_session(device).engine
    parts = partition_fact_table(tree, num_parts)

    def qr(t):
        return engine.qr(build_plan(t), dtype=dtype, method=method,
                         use_kernel=use_kernel, assembly=assembly,
                         device=device)

    if mesh is None:
        rs = [qr(t) for t in parts]
        stacked = torch.cat(rs)
        return normalize_sign(tsqr_r(stacked, leaf_rows=max(
            r.shape[0] for r in rs)))
    p = mesh.size
    mine = [qr(t) for t in parts[mesh.local_rank()::p]]
    if p == 1:
        rs = mine
    else:
        import torch.distributed as dist

        # One slot per partition of the busiest rank; a rank with fewer
        # sends zero blocks that no partition reads back.
        n = sum(tree.db[name].num_data_cols for name in tree.preorder())
        local = torch.zeros((-(-len(parts) // p), n, n), dtype=dtype,
                            device=device)
        for j, r in enumerate(mine):
            local[j] = r
        gathered = [torch.empty_like(local) for _ in range(p)]
        dist.all_gather(gathered, local, group=mesh.group)
        rs = [gathered[i % p][i // p] for i in range(len(parts))]
    return distributed_postprocess_r0(torch.cat(rs), mesh, axis,
                                      use_kernel=use_kernel)
