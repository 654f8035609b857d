"""Async-first FiGaRo serving: request queue, futures, pipelined dispatch.

The port of the JAX package's ``train/async_serve.py``. One join structure
(a capacity plan held by a `plan_cache.PlanHolder`) answers many users'
feature-sets; `AsyncFigaroServer` turns that into a small pipeline:

  * ``submit(request) -> FigaroFuture`` enqueues one request (per-node
    [m_i, n_i] leaves) or a sub-batch ([B, m_i, n_i] leaves, B=0 included)
    onto a micro-batching queue;
  * a dispatcher thread coalesces pending requests up to ``max_batch`` rows,
    stages the coalesced batch on the card (`FigaroEngine.stage`: the
    requests' leaves copied once, straight into pinned host buffers, then
    to the card on a copy stream of the engine's own, with an event the
    dispatch waits on) and dispatches it at its bucketed capacity
    (`launch.mesh.serving_batch_capacity`, the engine's
    ``batch_capacity=``), so a bucket's batches replay one captured graph.
    Dispatch only enqueues work on the card, so with ``queue_depth >= 2``
    the next batch's host-to-device copy runs beside the current batch's
    kernels;
  * a completion thread waits on an event recorded on the dispatch's stream
    after its last kernel (not on the whole card, which would also wait for
    the next batch) and resolves futures strictly in submission order.
    Exceptions propagate per request: a request that fails validation
    resolves only its own future, and if a coalesced dispatch fails, each
    batched request is re-dispatched alone so one poisoned request cannot
    fail its batchmates. An error that poisons the CUDA context fails every
    re-dispatch as well;
  * ``append(node, rows)`` joins the same stream: it drains in-flight work,
    then refreshes the shared `PlanHolder` (no signature miss while live
    sizes stay within capacity), so the owning `JoinDataset`'s plan and
    ``stats()`` never fork from the server's.

Over a data mesh of P > 1 ranks (one process per rank) every rank builds
the server and rank 0 controls it. Rank 0's server has the whole surface
above; its dispatch thread streams each step on the mesh's control group
(`launch.mesh.DataMesh`): a batch header (live size, bucketed capacity,
padded size, rank 0's plan signature, each leaf's shape and dtype), then
each rank's rows of the padded batch alone (``scatter``); appends and
re-roots of the shared plan holder at the same point of the stream; a stop
when it closes (and, while idle, a keep-alive within the group's timeout).
Every other rank (a follower) runs its dispatch thread on that stream from
construction on: it stages its rows (`FigaroEngine.stage` with ``live=``),
dispatches them through ``shard=`` and applies plan changes to its own
holder; its ``submit``, ``__call__``, ``append``, ``pause`` and ``resume``
raise, and its ``close`` returns when rank 0 closes. On every rank only the
dispatch thread issues collectives, in stream order. A sharded dispatch
agrees across ranks before its gather (`DataMesh.agree`), so a batch that
fails on one rank fails on all; rank 0 then sends each of its requests
alone, and only the poisoned request's future fails. At P = 1 nothing of
this runs and the server issues no collective.

The synchronous `FigaroServer` (`train.serve`) is a thin
``submit(...).result()`` wrapper over this machinery. Its threads and locks
go through the port's sanitizer (`san_thread`, `san_lock`,
`san_condition`), as the JAX package's do.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import queue
import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.core.engine import _rows_of, _sharded_size, map_result
from repro_torch.core.join_tree import FigaroPlan
from repro_torch.core.plan_cache import (PlanHolder, pad_data,
                                         plan_signature, replan_onto)
from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import RankDispatchError, serving_batch_capacity
from repro_torch.sanitizer.locks import san_condition, san_lock
from repro_torch.sanitizer.races import shared_state
from repro_torch.sanitizer.threads import san_thread

__all__ = ["SERVE_KINDS", "validate_serve_kind", "FigaroFuture",
           "AsyncFigaroServer"]

#: The serving kinds every serving surface supports (`make_figaro_server`,
#: `Session.serve`, `JoinDataset.serve`) — validated eagerly, in one place.
SERVE_KINDS = ("qr", "svd", "pca", "lsq")


def validate_serve_kind(kind: str, *, label_col=None,
                        check_label: bool = False) -> None:
    """Eager serve-kind validation shared by every serving entry point.

    A bad ``kind`` must fail at construction with the full list of supported
    kinds — not at (or after) the first dispatch. ``check_label=True`` also
    enforces the lsq label requirement.
    """
    if kind not in SERVE_KINDS:
        raise ValueError(f"unknown serve kind {kind!r}; supported kinds: "
                         f"{', '.join(SERVE_KINDS)}")
    if check_label and kind == "lsq" and label_col is None:
        raise ValueError("kind='lsq' needs label_col")


class FigaroFuture(concurrent.futures.Future):
    """Result handle for one submitted request (or sub-batch).

    A thin `concurrent.futures.Future` (stdlib semantics for
    ``result(timeout)`` / ``exception(timeout)`` / ``done()`` /
    ``add_done_callback``), resolved by the server's completion thread in
    submission order. ``result()`` re-raises the request's own exception if
    it failed — validation errors and poisoned-dispatch errors are
    per-request, batchmates are unaffected.
    """

    def _resolve(self, value=None, error: BaseException | None = None):
        if error is not None:
            self.set_exception(error)
        else:
            self.set_result(value)


class _Request:
    """One queue entry: a validated (or failed-at-validation) request."""

    __slots__ = ("future", "arrays", "b", "single", "sig", "plan", "error")

    def __init__(self):
        self.future = FigaroFuture()
        self.arrays = None  # capacity-shaped [b, m_i, n_i] leaves
        self.b = 0
        self.single = False  # squeeze the leading axis on resolve
        self.sig = None  # coalescing-compatibility key
        self.plan: FigaroPlan | None = None
        self.error: BaseException | None = None

    def _fail(self, error: BaseException) -> None:
        if not self.future.done():
            self.future._resolve(error=error)


_SHUTDOWN = object()


class _Control:
    """A change of the shared plan (``"append"`` rows or a ``"replace"``
    plan) that rank 0's caller thread queues for its dispatch thread, which
    applies it and streams it to the other ranks."""

    __slots__ = ("op", "payload", "future")

    def __init__(self, op: str, payload):
        self.op = op
        self.payload = payload
        self.future = concurrent.futures.Future()

    def _fail(self, error: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(error)


@shared_state({"_broken": "_lock", "_last_send": "_lock"})
class _MeshLink:
    """One rank's end of a server's stream on the mesh's control group:
    rank 0 sends, the others receive. It holds no reference to the server,
    so the dispatch loop of a collected server can still send the stop.
    Only the dispatch thread calls its collectives."""

    def __init__(self, mesh, config: dict):
        import torch.distributed as dist

        self._lock = san_lock("server.link")
        self.dist = dist
        self.mesh = mesh
        self.config = config
        self.src = mesh.ranks[0]
        self.rank = mesh.local_rank()
        # A follower waits on the next header for at most the group's
        # timeout: rank 0 sends a keep-alive well within it while idle.
        self.keepalive = mesh.timeout.total_seconds() / 4 \
            if mesh.timeout is not None else 15.0
        self.ready: concurrent.futures.Future = concurrent.futures.Future()
        self._broken: BaseException | None = None
        self._last_send = time.monotonic()

    @property
    def broken(self) -> BaseException | None:
        with self._lock:
            return self._broken

    @contextlib.contextmanager
    def collective(self):
        """Collectives of the stream: an error other than the ranks' agreed
        failure breaks it (every later step fails at once)."""
        with self._lock:
            if self._broken is not None:
                raise RuntimeError(f"the serving stream over the mesh "
                                   f"broke: {self._broken}")
        try:
            yield
        except RankDispatchError:
            raise
        except Exception as e:
            with self._lock:
                self._broken = e
            raise

    def handshake(self) -> None:
        """Every rank's server configuration against rank 0's: a mismatch
        raises `ValueError` on every rank. Sets ``ready``."""
        try:
            got = [None] * self.mesh.size
            with self.collective():
                self.dist.all_gather_object(got, self.config,
                                            group=self.mesh.control)
            differ = {r: sorted(k for k in c if c[k] != got[0].get(k))
                      for r, c in enumerate(got) if c != got[0]}
            if differ:
                raise ValueError(
                    "every rank must serve the same plan with the same "
                    "options; these ranks differ from rank 0 in: "
                    + "; ".join(f"rank {r}: {', '.join(ks)}"
                                for r, ks in sorted(differ.items())))
        except BaseException as e:
            self.ready.set_exception(e)
            return
        self.ready.set_result(None)

    def send(self, header: dict) -> None:
        with self.collective():
            self.dist.broadcast_object_list([header], src=self.src,
                                            group=self.mesh.control)
        with self._lock:
            self._last_send = time.monotonic()

    def recv(self) -> dict:
        box = [None]
        with self.collective():
            self.dist.broadcast_object_list(box, src=self.src,
                                            group=self.mesh.control)
        return box[0]

    def scatter(self, parts, shape, dtype) -> torch.Tensor:
        """This rank's part: rank 0 passes every rank's (``parts``), the
        others None."""
        out = torch.empty(shape, dtype=dtype)
        with self.collective():
            self.dist.scatter(out, parts, src=self.src,
                              group=self.mesh.control)
        return out

    def agree(self, error: BaseException | None) -> None:
        with self.collective():
            self.mesh.agree(error)

    def fail(self, error: BaseException) -> None:
        """Break the stream with ``error`` (a fault outside the
        collectives: the other ranks see the stream stop)."""
        with self._lock:
            if self._broken is None:
                self._broken = error

    def keep_alive(self) -> None:
        """A no-op header when nothing was sent for a keep-alive period."""
        with self._lock:
            due = self._broken is None and \
                time.monotonic() - self._last_send >= self.keepalive
        if due:
            try:
                self.send({"op": "noop"})
            except Exception:  # noqa: BLE001 — the stream is broken now
                pass

    def stop(self) -> None:
        """Release the followers (nothing to send on a broken stream)."""
        if self.broken is None:
            try:
                self.send({"op": "stop"})
            except Exception:  # noqa: BLE001 — the stream is broken now
                pass


def _slice_out(out, offset: int, b: int, single: bool):
    """This request's slice of a coalesced batch output."""
    if single:
        return map_result(lambda x: x[offset], out)
    return map_result(lambda x: x[offset:offset + b], out)


def _ready_event(out):
    """An event recorded on the current stream after the dispatch that made
    ``out`` (None on the CPU, where the result is ready when returned). It
    is a blocking-sync event: the completion thread sleeps on it instead of
    spinning, which would take a core from the dispatch thread's copy of
    the next batch into pinned memory."""
    leaf = out
    while not isinstance(leaf, torch.Tensor):
        leaf = leaf[0] if isinstance(leaf, tuple) else leaf.components
    if leaf.device.type != "cuda":
        return None
    event = torch.cuda.Event(blocking=True)
    event.record(torch.cuda.current_stream(leaf.device))
    return event




def _concat(parts):
    """One coalesced leaf from the requests' leaves (numpy or tensors)."""
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts)
    return torch.cat([torch.as_tensor(p) for p in parts])


# The worker loops hold only a weakref to the server (plus its queues), so an
# abandoned server can be garbage-collected; its finalizer posts _SHUTDOWN and
# the threads exit instead of leaking for the life of the process.

def _wait_gate(server_ref, link=None):
    """Wait out a pause() hold WITHOUT keeping the server strongly
    referenced: a paused, abandoned server must stay collectable (its
    finalizer posts the shutdown sentinel) — blocking inside a server method
    would pin it alive, and its threads, forever. Returns the live server
    once the gate is open, or None if it was collected meanwhile. A
    controller keeps its followers' stream alive meanwhile."""
    while True:
        server = server_ref()
        if server is None:
            return None
        gate = server._run_gate
        del server
        if gate.wait(timeout=0.2):
            return server_ref()
        if link is not None:
            link.keep_alive()


def _next_item(in_q, link):
    """The next queue entry; a controller sends keep-alives while idle."""
    if link is None:
        return in_q.get()
    while True:
        try:
            return in_q.get(timeout=link.keepalive / 2)
        except queue.Empty:
            link.keep_alive()


def _dispatch_loop(server_ref, in_q, out_q, link=None):
    if link is not None:  # a controller: the ranks agree first
        link.handshake()
        if link.ready.exception() is not None:
            out_q.put(_SHUTDOWN)
            return
    leftover = None
    while True:
        item = leftover if leftover is not None else _next_item(in_q, link)
        leftover = None
        server = _wait_gate(server_ref, link) if item is not _SHUTDOWN \
            else None
        if item is _SHUTDOWN or server is None:
            if link is not None:
                link.stop()
            # Shut down on the queue handles, NOT through the server: when
            # the finalizer of a GC'd server posts _SHUTDOWN, the weakref is
            # already dead — the completion thread must still be released,
            # and any still-queued requests must fail rather than hang their
            # futures (close() drains first, so this only fires for GC).
            dead = RuntimeError("server closed or garbage-collected before "
                                "the request was dispatched")
            while True:
                if item is not _SHUTDOWN and item is not None:
                    item._fail(dead)
                try:
                    item = in_q.get_nowait()
                except queue.Empty:
                    break
            out_q.put(_SHUTDOWN)
            return
        try:
            if isinstance(item, _Control):
                server._apply_control(item)
            else:
                leftover = server._dispatch_one(item)
        except BaseException as e:  # defensive: the loop must survive
            server._fail_item(item, e)
        del server


def _follow_loop(server, link):
    """A follower's dispatch thread: rank 0's stream until its stop."""
    link.handshake()
    if link.ready.exception() is not None:
        return
    while True:
        try:
            header = link.recv()
        except Exception:  # noqa: BLE001 — kept in link.broken for close()
            return
        if header["op"] == "stop":
            return
        try:
            server._follow(header)
        except RankDispatchError:
            continue  # failed on every rank: rank 0 answers for it
        except Exception as e:  # noqa: BLE001 — close() raises it
            link.fail(e)
            return


def _complete_loop(server_ref, out_q):
    while True:
        got = out_q.get()
        server = server_ref() if got is not _SHUTDOWN else None
        if got is _SHUTDOWN or server is None:
            # A dead weakref means the server was collected with groups
            # still in flight (nobody kept a server reference, only
            # futures): fail them — silently returning would leave those
            # futures unresolved forever. close() drains before shutdown,
            # so the sentinel path normally finds the queue empty.
            dead = RuntimeError("server closed or garbage-collected before "
                                "the request was answered")
            while True:
                if got is not _SHUTDOWN and got is not None:
                    for it in got[0]:
                        it._fail(dead)
                try:
                    got = out_q.get_nowait()
                except queue.Empty:
                    return
        try:
            server._resolve_group(*got)
        except BaseException as e:  # defensive: resolve rather than hang
            for it in got[0]:
                if not it.future.done():
                    it.future._resolve(error=e)
                    server._done_one()
            server._depth_sem.release()
        del server


@shared_state({"_outstanding": "_cond", "_closed": "_close_lock",
               "_threads": "_thread_lock"})
class AsyncFigaroServer:
    """Pipelined micro-batching serving endpoint for one join structure.

    Construct through `make_figaro_server` / ``ds.serve(kind=...)`` — see
    the module docstring for the pipeline. The public surface:

    ``submit(request)``
        Enqueue per-node request leaves ([m_i, n_i] for one request,
        [B, m_i, n_i] for a sub-batch; numpy arrays or tensors; rows at the
        live size are zero-padded to capacity, any other row count fails
        that request's future). Returns a `FigaroFuture`.
    ``server(data_batch)``
        Synchronous convenience: ``submit(data_batch).result()``.
    ``append(node, rows)``
        Drain in-flight work, then append ``rows = (key_columns,
        data_rows)`` to relation ``node`` through the shared `PlanHolder` —
        the owning `JoinDataset` (and every sibling server) sees the same
        refreshed plan. True = still within capacity (no signature miss).
    ``flush()`` / ``close()`` / ``pause()`` / ``resume()``
        Drain outstanding requests; shut the worker threads down; hold /
        release the coalescer (pause + submit + resume dispatches one
        maximally-coalesced batch deterministically — useful for warm-up and
        for tests asserting coalesced-batch identities).

    With ``mesh=(mesh, axis)`` the batch capacities align to the axis;
    over P > 1 ranks the server is rank 0's controller or another rank's
    follower (module docstring), and ``config`` is what every rank must
    share with rank 0 (checked at construction, on every rank, by the
    dispatch thread).
    """

    def __init__(self, holder: PlanHolder, dispatch_fn, *, engine=None,
                 device=None, max_batch: int = 32, queue_depth: int = 2,
                 mesh=None, config=None):
        if holder.plan is None:
            raise ValueError("AsyncFigaroServer needs a holder with a built "
                             "plan")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        axis_size = 1 if mesh is None else mesh[0].size
        self._holder = holder
        self._dispatch_fn = dispatch_fn  # (plan, batch, batch_capacity) -> out
        self._capacity_for = functools.partial(serving_batch_capacity,
                                               axis_size=axis_size)
        # Stage (the copy to the card ahead of the dispatch) through the
        # engine, when the server runs on the card.
        self._engine_stage = (functools.partial(engine.stage, device=device)
                              if engine is not None and axis_size == 1
                              and resolve_device(device).type == "cuda"
                              else None)
        self.max_batch = max_batch
        self.queue_depth = queue_depth
        self._in_q: queue.Queue = queue.Queue()
        self._out_q: queue.Queue = queue.Queue()
        self._depth_sem = threading.Semaphore(queue_depth)
        self._run_gate = threading.Event()
        self._run_gate.set()
        # Sanitizer-aware locks (FIG007), created before the state they
        # guard so the race detector can resolve them mid-__init__.
        self._cond = san_condition("server._cond")
        self._close_lock = san_lock("server._close_lock")  # closed vs enqueue
        self._thread_lock = san_lock("server._thread_lock")
        self._outstanding = 0
        self._closed = False
        self._threads: list | None = None  # the two worker threads
        self._finalizer = weakref.finalize(self, self._in_q.put, _SHUTDOWN)
        # Over P > 1 ranks: this rank's end of the stream, and the engine's
        # staging of this rank's rows and release of superseded graphs.
        streamed = mesh is not None and mesh[0].size > 1
        if streamed:
            mesh[0].check_control()
            if engine is None:
                raise ValueError("a server over a mesh of several ranks "
                                 "needs its engine (it stages each rank's "
                                 "rows)")
        self._link = _MeshLink(mesh[0], config or {}) if streamed else None
        self._stage_rows = functools.partial(
            engine.stage, shard=mesh, device=device) if streamed else None
        self._release_graphs = engine.release_graphs if streamed else None
        if streamed:
            self._start_stream()

    def _start_stream(self) -> None:
        """Join the mesh's stream: attach to the holder as its router,
        start the dispatch thread, and wait for its check of every rank's
        configuration against rank 0's."""
        self._holder.attach_controller(self)
        self._ensure_threads()
        try:
            self._link.ready.result()
        except BaseException:
            self._holder.detach_controller(self)
            with self._close_lock:
                self._closed = True
            # The failed check ends the threads: none outlives the raise.
            with self._thread_lock:
                threads = self._threads
            for t in threads:
                t.join(timeout=10.0)
            raise

    @property
    def _follower(self) -> bool:
        return self._link is not None and self._link.rank != 0

    def _refuse_on_follower(self, what: str) -> None:
        if self._follower:
            raise RuntimeError(
                f"{what} is rank 0's: a server over the mesh takes requests "
                f"and plan changes on rank 0 only (this is rank "
                f"{self._link.rank}, which follows rank 0's stream)")

    # -- plan lifecycle (shared with the owning JoinDataset) -----------------

    @property
    def plan(self) -> FigaroPlan:
        """The currently-served plan — the shared holder's, never a fork.

        Every request captures this plan at *submit* time (``item.plan``),
        and dispatch uses the captured plan — so a holder-level swap (an
        append refresh, or an adaptive re-root via `PlanHolder.replace`)
        never changes the plan a pending future is answered with: the swap
        paths drain first, and anything submitted before the drain resolves
        bit-identically to the pre-swap plan."""
        return self._holder.plan

    def append(self, node: str, rows) -> bool:
        """Append ``rows = (key_columns, data_rows)`` to relation ``node``.

        Drains in-flight work first (queued requests were validated against
        the old capacities), then refreshes the shared plan holder. Returns
        True when the refresh stayed within the plan's capacities — the next
        dispatch replays the captured graph, no miss. Appends through a
        dataset with adaptive re-rooting (``ds.append``) may additionally
        swap the orientation at the same drain point; requests submitted
        after the swap validate against — and are answered on — the new
        plan's layout. Over a mesh, the change rides rank 0's stream to
        every rank, before any batch submitted after it."""
        self._refuse_on_follower("append")
        return self._holder.refresh({node: rows})

    def route(self, op: str, payload):
        """Apply a change of the shared plan (``"append"`` rows, or a
        ``"replace"`` plan) through the stream: rank 0's dispatch thread
        applies it and sends it to every rank. The holder calls this after
        its drain; it blocks until every rank applied the change."""
        self._refuse_on_follower(f"a plan {op}")
        item = _Control(op, payload)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._in_q.put(item)
        return item.future.result()

    # -- submission ----------------------------------------------------------

    def submit(self, request) -> FigaroFuture:
        """Enqueue one request ([m_i, n_i] leaves) or a sub-batch
        ([B, m_i, n_i]); returns a `FigaroFuture` resolved in submission
        order. Validation failures resolve this future alone."""
        self._refuse_on_follower("submit")
        item = _Request()
        try:
            self._prepare(item, request)
        except Exception as e:
            item.error = e
        # The closed check and the enqueue are one atomic step against
        # close(): without the lock, a submit racing close() could enqueue
        # its item AFTER the shutdown sentinel and hang its future forever.
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            with self._cond:
                self._outstanding += 1
            self._ensure_threads()
            self._in_q.put(item)
        return item.future

    def __call__(self, data_batch):
        """Synchronous dispatch: ``submit(data_batch).result()``."""
        return self.submit(data_batch).result()

    def _prepare(self, item: _Request, request) -> None:
        plan = self._holder.plan
        data = tuple(request)
        if len(data) != len(plan.spec.nodes):
            raise ValueError(
                f"expected one data leaf per relation "
                f"({len(plan.spec.nodes)}: {list(plan.spec.names)}), "
                f"got {len(data)}")
        data = tuple(d if isinstance(d, torch.Tensor) else np.asarray(d)
                     for d in data)
        ndims = {d.ndim for d in data}
        if ndims == {2}:
            item.single = True
            data = tuple(d[None] for d in data)
        elif ndims != {3}:
            raise ValueError(
                "request leaves must all be [rows_i, n_i] (one request) or "
                f"all [B, rows_i, n_i] (a sub-batch); got ndims {sorted(ndims)}")
        bs = {int(d.shape[0]) for d in data}
        if len(bs) != 1:
            raise ValueError(f"request leaves disagree on the batch size: "
                             f"{sorted(bs)}")
        if not all(d.shape[-2] == sp.m for d, sp in zip(data,
                                                        plan.spec.nodes)):
            for d, sp, ix in zip(data, plan.spec.nodes, plan.index):
                live = int(ix.row_mask.sum()) if ix.row_mask is not None \
                    else sp.m
                if d.shape[-2] not in (live, sp.m):
                    raise ValueError(
                        f"{sp.name}: request batch has {d.shape[-2]} "
                        f"rows; expected the live size ({live}) or the "
                        f"capacity ({sp.m}) — rebuild request buffers after "
                        f"append()")
            data = pad_data(data, plan.spec)
        item.arrays = data
        item.b = bs.pop()
        item.plan = plan
        item.sig = (id(plan), tuple((str(d.dtype), str(getattr(
            d, "device", "cpu"))) for d in data))

    # -- worker plumbing -----------------------------------------------------

    def _ensure_threads(self) -> None:
        # No unlocked fast-path read: `_threads` is written under
        # `_thread_lock`, so the check must hold it too (the uncontended
        # acquire is cheap, and the lockset race detector would rightly flag
        # the bare read once a second thread has gone through here).
        with self._thread_lock:
            if self._threads is not None:
                return
            ref = weakref.ref(self)
            if self._follower:  # holds the server until rank 0's stop
                threads = [san_thread(_follow_loop, args=(self, self._link),
                                      name="figaro-serve-dispatch",
                                      daemon=True)]
            else:
                threads = [
                    san_thread(_dispatch_loop,
                               args=(ref, self._in_q, self._out_q,
                                     self._link),
                               name="figaro-serve-dispatch", daemon=True),
                    san_thread(_complete_loop, args=(ref, self._out_q),
                               name="figaro-serve-complete", daemon=True),
                ]
            for t in threads:
                t.start()
            self._threads = threads

    def _dispatch_one(self, first: _Request):
        """Coalesce a group starting at ``first``, dispatch it, hand it to
        the completion thread. Returns a popped-but-incompatible request to
        seed the next group (or _SHUTDOWN, passed through). The pause() gate
        was already waited out by the dispatch loop (without a strong server
        reference), so the queue behind ``first`` is fully drained here."""
        group = [first]
        live_sig = first.sig if first.error is None else None
        total_b = first.b if first.error is None else 0
        leftover = None
        while total_b < self.max_batch:
            try:
                nxt = self._in_q.get_nowait()
            except queue.Empty:
                break
            # Stop at a shutdown sentinel, an incompatible request, or a
            # sub-batch that would push the group past max_batch (a single
            # oversized submit still dispatches alone — it cannot be split);
            # the popped item seeds the next group, preserving FIFO order.
            # A plan change ends the group too.
            if nxt is _SHUTDOWN or isinstance(nxt, _Control) or (
                    nxt.error is None and (
                    (live_sig is not None and nxt.sig != live_sig)
                    or total_b + nxt.b > self.max_batch)):
                leftover = nxt
                break
            group.append(nxt)
            if nxt.error is None:
                live_sig = live_sig or nxt.sig
                total_b += nxt.b
        live = [it for it in group if it.error is None]
        payload = None
        self._depth_sem.acquire()  # ≤ queue_depth coalesced batches in flight
        if live and self._link is not None and total_b:
            payload = self._stream_group(live, total_b)
        elif live:
            try:
                if len(live) == 1:
                    data = live[0].arrays
                elif self._engine_stage is not None:
                    # `stage` concatenates the parts of each leaf as it
                    # copies them into its pinned buffer: one host pass
                    data = tuple([it.arrays[j] for it in live]
                                 for j in range(len(live[0].arrays)))
                else:
                    data = tuple(_concat([it.arrays[j] for it in live])
                                 for j in range(len(live[0].arrays)))
                if self._engine_stage is not None:
                    data = self._engine_stage(data)
                out = self._dispatch_fn(live[0].plan, data,
                                        self._capacity_for(total_b) or None)
                del data  # donated: the dispatch consumed the staged batch
                payload = (out, _ready_event(out), None, None)
            except Exception as e:
                payload = (None, None, e, None)
        self._out_q.put((group, live, payload))
        return leftover

    # -- the stream over a mesh (rank 0) --------------------------------------

    def _stream_group(self, live, total_b):
        """A coalesced group through the stream. If the ranks agree that it
        failed, each request goes again alone, as a batch of its own, so
        the completion thread (which issues no collective) only resolves."""
        try:
            out = self._send_batch(live[0].plan, live, total_b)
            return (out, _ready_event(out), None, None)
        except RankDispatchError as e:
            if len(live) == 1:
                return (None, None, e, None)
            alone = {}
            for it in live:
                try:
                    o = self._send_batch(it.plan, [it], it.b)
                    alone[id(it)] = (o, _ready_event(o), None)
                except Exception as e_it:
                    alone[id(it)] = (None, None, e_it)
            return (None, None, e, alone)
        except Exception as e:
            return (None, None, e, None)

    def _send_batch(self, plan, items, b: int):
        """One BATCH item: the header to every rank, each rank its own rows
        of the padded batch (the trailing request repeated, as a sharded
        dispatch pads), then this rank's part of the dispatch."""
        if b == 0:  # nothing to split: the engine answers it alone
            return self._dispatch_fn(plan, items[0].arrays, None)
        link, mesh = self._link, self._link.mesh
        cap = self._capacity_for(b)
        q = _sharded_size(b, cap, mesh.size) // mesh.size
        parts = []
        for j in range(len(items[0].arrays)):
            leaf = [torch.as_tensor(it.arrays[j]) for it in items]
            parts.append([torch.cat(_rows_of(leaf, r * q, (r + 1) * q, b))
                          .cpu().contiguous() for r in range(mesh.size)])
        link.send({"op": "batch", "b": b, "cap": cap, "padded": q * mesh.size,
                   "sig": plan_signature(plan),
                   "leaves": [(tuple(p[0].shape), p[0].dtype)
                              for p in parts]})
        rows = [link.scatter(p, p[0].shape, p[0].dtype) for p in parts]
        return self._dispatch_rows(plan, rows, b, cap)

    def _dispatch_rows(self, plan, rows, b: int, cap: int, error=None):
        """This rank's part of a streamed batch: its rows staged (tagged as
        ``stage(shard=)`` tags them) and dispatched through ``shard=``,
        whose agreement makes a failure on any rank fail on every rank."""
        link = self._link
        staged = None
        if error is None:
            try:
                staged = self._stage_rows(rows, live=b, batch_capacity=cap)
            except Exception as e:
                error = e
        if error is not None:
            link.agree(error)  # raises on every rank
        with link.collective():
            return self._dispatch_fn(plan, staged, cap)

    def _apply_control(self, item: _Control) -> None:
        """A plan change on rank 0's dispatch thread: applied to the holder
        here, then sent, applied by every rank and agreed on."""
        holder, link = self._holder, self._link
        try:
            if link.broken is not None:
                raise RuntimeError(f"the serving stream over the mesh "
                                   f"broke: {link.broken}")
            if item.op == "append":
                result = holder.apply_refresh(item.payload)
                header = {"op": "append", "rows": item.payload}
            else:
                result = holder.apply_replace(item.payload)
                plan = holder.plan
                header = {"op": "replace",
                          "parent": dict(plan.source_tree.parent),
                          "spec": plan.spec,
                          "headroom": getattr(plan, "capacity_headroom", 0)}
            header["sig"] = plan_signature(holder.plan)
        except Exception as e:
            item._fail(e)  # applied nowhere: nothing was sent
            return
        try:
            link.send(header)
            link.agree(None)
        except Exception as e:
            item._fail(e)
            return
        item.future.set_result(result)

    # -- the stream over a mesh (a follower) ----------------------------------

    def _follow(self, header: dict) -> None:
        """One item of rank 0's stream on a follower's dispatch thread."""
        link, holder = self._link, self._holder
        op = header["op"]
        if op == "noop":
            return
        if op == "batch":
            rows = [link.scatter(None, shape, dtype)
                    for shape, dtype in header["leaves"]]
            plan = holder.plan
            error = None
            if plan_signature(plan) != header["sig"]:
                error = ValueError(
                    f"rank {link.rank} holds another plan than the batch's "
                    f"(rank 0's): plans differ after a change that raced "
                    f"the request")
            self._dispatch_rows(plan, rows, header["b"], header["cap"],
                                error)
            return
        error = None
        try:
            old = holder.plan.spec
            if op == "append":
                holder.apply_refresh(header["rows"])
            else:
                holder.apply_replace(replan_onto(
                    holder.plan, header["parent"], header["spec"],
                    header["headroom"]))
            if plan_signature(holder.plan) != header["sig"]:
                raise ValueError(f"after the plan {op}, rank {link.rank}'s "
                                 f"plan differs from rank 0's")
            if holder.plan.spec != old:
                self._release_graphs(old)  # as JoinDataset.append does
        except Exception as e:
            error = e
        link.agree(error)

    def _resolve_group(self, group, live, payload) -> None:
        out, ready, err, alone = payload if payload is not None \
            else (None, None, None, None)
        if err is None and ready is not None:
            try:
                ready.synchronize()
            except Exception as e:
                err, out = e, None
        results, errors = {}, {}
        if live and err is None and out is not None:
            offset = 0
            for it in live:
                results[id(it)] = _slice_out(out, offset, it.b, it.single)
                offset += it.b
        elif alone is not None:
            # Each request went again alone through the stream.
            for it in live:
                o, r, e = alone[id(it)]
                if e is None and r is not None:
                    try:
                        r.synchronize()
                    except Exception as e_sync:
                        e = e_sync
                if e is None:
                    results[id(it)] = _slice_out(o, 0, it.b, it.single)
                else:
                    errors[id(it)] = e
        elif len(live) > 1 and self._link is None:
            # A coalesced dispatch failed: isolate the poisoned request(s) by
            # re-dispatching each request alone — batchmates still succeed.
            for it in live:
                try:
                    o = self._dispatch_fn(it.plan, it.arrays,
                                          self._capacity_for(it.b) or None)
                    ready = _ready_event(o)
                    if ready is not None:
                        ready.synchronize()
                    results[id(it)] = _slice_out(o, 0, it.b, it.single)
                except Exception as e:
                    errors[id(it)] = e
        elif live:
            errors[id(live[0])] = err
        for it in group:  # strictly submission order
            if it.error is not None:
                it.future._resolve(error=it.error)
            elif id(it) in results:
                it.future._resolve(value=results[id(it)])
            else:
                it.future._resolve(error=errors.get(id(it), err))
            self._done_one()
        self._depth_sem.release()

    def _fail_item(self, item, error: BaseException) -> None:
        if isinstance(item, _Control):
            item._fail(error)
        elif isinstance(item, _Request) and not item.future.done():
            item.future._resolve(error=error)
            self._done_one()

    def _done_one(self) -> None:
        with self._cond:
            self._outstanding -= 1
            self._cond.notify_all()

    # -- flow control --------------------------------------------------------

    def flush(self) -> None:
        """Block until every submitted request has been answered.

        Releases a `pause` hold first: flush demands every queued request be
        answered, which a held coalescer could never do — without this,
        ``append`` (which drains every server attached to the plan holder,
        paused or not) would deadlock on a paused server's queued work.
        A follower holds no requests: it returns at once."""
        if self._follower:
            return
        self.resume()
        with self._cond:
            self._cond.wait_for(lambda: self._outstanding == 0)

    def pause(self) -> None:
        """Hold the coalescer: submitted requests queue up but do not
        dispatch until `resume` — pre-loading the queue this way yields one
        maximally-coalesced batch. `flush` / `append` / `close` release the
        hold (they require the queue to drain)."""
        self._refuse_on_follower("pause")
        self._run_gate.clear()

    def resume(self) -> None:
        self._refuse_on_follower("resume")
        self._run_gate.set()

    def close(self) -> None:
        """Drain outstanding work and stop the worker threads. Over a mesh,
        rank 0's stop releases the followers; a follower's close returns
        once rank 0 has closed (or raises what broke the stream)."""
        if self._follower:
            self._close_follower()
            return
        with self._close_lock:  # `_closed` is only ever read under the lock
            if self._closed:
                return
        self.flush()  # releases any pause() hold first
        threads = None
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            with self._thread_lock:
                threads = self._threads
            if threads is not None:
                self._in_q.put(_SHUTDOWN)
        if threads is not None:
            for t in threads:
                t.join(timeout=10.0)
        if self._link is not None:
            self._holder.detach_controller(self)

    def _close_follower(self) -> None:
        with self._close_lock:
            self._closed = True
            with self._thread_lock:
                threads = self._threads or []
        for t in threads:
            # Bounded: rank 0 sends within the group's timeout while it
            # lives, and a wait past it fails the thread's collective.
            while t.is_alive():
                t.join(timeout=1.0)
        self._holder.detach_controller(self)
        if self._link.broken is not None:
            raise RuntimeError(f"the serving stream over the mesh broke: "
                               f"{self._link.broken}") from self._link.broken

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
