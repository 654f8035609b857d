"""The batched FiGaRo factorization server.

The port of the FiGaRo half of the JAX package's ``train/serve.py``:
``make_figaro_server`` serves one join structure (a `FigaroPlan`) to many
concurrent users' feature-sets — each dispatch runs Algorithm 2 and the
post-processing over a leading batch axis through a `FigaroEngine` with
donated request tensors, so serving cost per request is one replay of the
bucket's captured graph on the card. The server is async-first
(`repro_torch.train.async_serve`): ``submit(request)`` returns a
`FigaroFuture`, pending requests coalesce into bucketed micro-batches, and
queue depth >= 2 overlaps the next batch's host-to-device copy with the
in-flight dispatch; the synchronous `FigaroServer` call is a
``submit(...).result()`` wrapper.

The LM half of that module (``make_prefill``, ``make_decode_step``,
``sample_loop``, ``cache_specs``) is ROADMAP item A14.1 and not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import FigaroEngine, _plan_arg_error
from repro_torch.core.join_tree import FigaroPlan
from repro_torch.core.plan_cache import PlanHolder, plan_signature
from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import resolve_shard
from repro_torch.train.async_serve import (AsyncFigaroServer, FigaroFuture,
                                           SERVE_KINDS, validate_serve_kind)

__all__ = ["make_figaro_server", "FigaroServer", "AsyncFigaroServer",
           "FigaroFuture", "SERVE_KINDS", "validate_serve_kind"]


class FigaroServer(AsyncFigaroServer):
    """The synchronous face of `AsyncFigaroServer`.

    ``server(data_batch)`` is exactly ``server.submit(data_batch).result()``:
    the request rides the same micro-batching queue and pipelined dispatch,
    the call just blocks for its own answer. ``server.append(node, rows)``
    (``rows = (key_columns, data_rows)`` as in `plan_cache.refresh_plan`)
    drains in-flight work and refreshes the shared plan holder: as long as
    the new live sizes fit the plan's bucketed capacities, the next dispatch
    replays the captured graph — no signature miss under streaming appends.

    Capacity contract for requests: batch leaves are [B, rows_i, n_i] in the
    plan's (sorted) row order with ``rows_i`` either the node's live size or
    its full capacity; live-sized leaves are zero-padded up to capacity
    (the dead rows are masked out inside the pipeline regardless).
    """


def make_figaro_server(plan: FigaroPlan | PlanHolder, *, kind: str = "qr",
                       label_col: int | None = None, k: int | None = None,
                       ridge: float = 0.0, dtype=torch.float32,
                       method: str = "tsqr", leaf_rows: int = 256,
                       use_kernel: bool = False, assembly: str = "padded",
                       engine: FigaroEngine | None = None, mesh=None,
                       shard_axis: str = "data", max_batch: int = 32,
                       queue_depth: int = 2, device=None) -> FigaroServer:
    """Batched FiGaRo serving endpoint for one join structure.

    Returns a `FigaroServer` (an `AsyncFigaroServer` whose ``__call__``
    blocks) — ``server.submit(request)`` enqueues per-node [m_i, n_i]
    request leaves (or a [B, m_i, n_i] sub-batch) and returns a
    `FigaroFuture`; ``server(data_batch)`` answers synchronously:

      kind="qr"   -> R      [B, N, N]
      kind="svd"  -> (s [B, N], Vt [B, N, N])
      kind="pca"  -> PCAResult with a leading batch axis (top-``k``)
      kind="lsq"  -> (betas [B, N-1], residuals [B]) against ``label_col``

    Pending requests are coalesced up to ``max_batch`` rows and the batch is
    padded to its bucketed capacity (powers of two), so every kind answers
    the whole coalesced batch with one dispatch, and the engine's cache and
    captured graphs track batch *buckets*, not every live batch size.
    ``queue_depth`` coalesced batches may be in flight at once: at depth
    >= 2 the next batch's staging overlaps the in-flight dispatch.

    The server runs on ``device`` (default: the card; ``"cpu"`` runs the
    kernels' plain versions). With a capacity plan
    (`plan_cache.build_capacity_plan`) the server also exposes
    ``server.append(node, rows)`` for online data refreshes. Pass a
    `plan_cache.PlanHolder` to share plan state with other surfaces (this is
    what ``JoinDataset.serve`` does — dataset and server then see one plan,
    never a fork).

    Without ``engine=``, the server builds a donating engine (request
    tensors are consumed by the dispatch that answers them). With a
    ``mesh`` (`launch.mesh.DataMesh`) the batch capacities are aligned to
    ``mesh[shard_axis]`` and every batch dispatches through
    ``shard=(mesh, shard_axis)``, as in the JAX package. Over P > 1 ranks
    (one process each) construction is collective: every rank calls this
    with a plan built from the same tables and the same options (checked
    on every rank; a mismatch raises `ValueError` on all of them). Rank 0's
    server decides each batch and takes requests, appends and ``close``;
    every other rank's server follows rank 0's stream (its ``close``
    returns when rank 0 closes) — see `repro_torch.train.async_serve`. On
    one rank nothing is exchanged. `repro_torch.figaro` (`Session.serve` /
    `JoinDataset.serve`) is the façade over this constructor — it fills
    engine, device, mesh and dtype from the session and resolves
    ``label_col`` by column name.
    """
    validate_serve_kind(kind, label_col=label_col, check_label=True)
    device = resolve_device(device)
    shard = None
    if mesh is not None:
        shard = resolve_shard(mesh, shard_axis)
        mesh.check_device(device)
        mesh.local_rank()
        mesh.check_control()
    if isinstance(plan, PlanHolder):
        holder = plan
    else:
        if not isinstance(plan, FigaroPlan):
            raise TypeError(_plan_arg_error("plan", plan))
        holder = PlanHolder(plan)
    engine = engine if engine is not None else FigaroEngine(donate_data=True)

    # use_kernel / assembly are part of every dispatch's signature, so the
    # serving graphs are the fused-kernel / band-assembly programs when the
    # session (or caller) asked for them.
    common = dict(batched=True, shard=shard, dtype=dtype, method=method,
                  leaf_rows=leaf_rows, use_kernel=use_kernel,
                  assembly=assembly, device=device)
    dispatch = {
        "qr": lambda plan, batch, cap: engine.qr(
            plan, batch, batch_capacity=cap, **common),
        "svd": lambda plan, batch, cap: engine.svd(
            plan, batch, batch_capacity=cap, **common),
        "pca": lambda plan, batch, cap: engine.pca(
            plan, batch, batch_capacity=cap, k=k, **common),
        "lsq": lambda plan, batch, cap: engine.least_squares(
            plan, label_col, batch, batch_capacity=cap, ridge=ridge,
            **common),
    }[kind]
    config = None
    if mesh is not None and mesh.size > 1 and holder.plan is not None:
        # What every rank must share with rank 0 (its dispatch thread
        # checks it on every rank before the first request).
        config = {"plan": plan_signature(holder.plan), "kind": kind,
                  "label_col": label_col, "k": k, "ridge": ridge,
                  "dtype": str(dtype), "method": method,
                  "leaf_rows": leaf_rows, "use_kernel": use_kernel,
                  "assembly": assembly, "axis": shard_axis}
    server = FigaroServer(holder, dispatch, engine=engine, device=device,
                          max_batch=max_batch, queue_depth=queue_depth,
                          mesh=shard, config=config)
    holder.attach(server)
    return server
