"""The serving data mesh and batch buckets of the JAX package's
``launch/mesh.py``.

`DataMesh` is a 1-D ``"data"`` axis over the ranks of a `torch.distributed`
process group: one rank per device and one process per rank, so a mesh of
P ranks is P processes, each on its own device (a card under NCCL, the CPU
under gloo). `make_data_mesh` builds it; `FigaroEngine`'s ``shard=`` splits
a request batch over it and `repro_torch.core.distributed` runs the TSQR
combine across it. Without an initialized process group the mesh is this
process alone (one rank, no group), and nothing on it issues a collective.

At P > 1 the mesh also holds a host-side control group (gloo, over the
same ranks, with the mesh's timeout): a server over the mesh streams its
batch headers and each rank's request rows on it
(`repro_torch.train.async_serve`), and every sharded dispatch agrees on it,
before its gather, whether any rank failed (`DataMesh.agree`).

`serving_batch_capacity` picks the request-batch capacity the async serving
queue (`repro_torch.train.async_serve`) dispatches a coalesced micro-batch
at. `make_host_mesh` is the LM trainer's one-rank mesh; the production mesh
and a host mesh with a ``model`` axis are ROADMAP item A14.6 and raise
`NotImplementedError` naming it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import weakref

import torch

from repro_torch.core.plan_cache import next_pow2
from repro_torch.kernels._platform import resolve_device

__all__ = ["DataMesh", "RankDispatchError", "resolve_shard",
           "serving_batch_capacity", "make_data_mesh", "make_production_mesh",
           "make_host_mesh"]


class RankDispatchError(RuntimeError):
    """Raised on every rank of a mesh when one rank's part of a collective
    step failed: ``rank`` is the lowest failing rank on the mesh's axis and
    ``message`` its error, as that rank rendered it."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank} of the mesh failed: {message}")
        self.rank = rank
        self.message = message


@dataclasses.dataclass(frozen=True, eq=False, init=False)
class DataMesh:
    """A 1-D ``"data"`` axis of ``size`` ranks.

    ``group`` is the process group of the ranks (None for a mesh of this
    process alone), ``ranks`` their global ranks in axis order, ``rank``
    this process's place on the axis (None when the process holds no rank
    of the mesh: it cannot dispatch on it), ``device`` this rank's device.
    ``control`` is the host-side gloo group over the same ranks that
    carries a server's stream and the ranks' agreement (None on one rank),
    ``timeout`` the bound of its collectives. ``shape`` reads like the JAX
    package's ``Mesh.shape``.

    The mesh refers to its process groups and does not own them:
    `torch.distributed` does, and ``destroy_process_group`` ends them, and
    joins their gloo threads, there and then, however long the mesh itself
    lives (a server over it is often kept in a reference cycle until the
    interpreter exits). A group's threads still running when the
    interpreter tears itself down can abort the process. Reading ``group``
    or ``control`` after their group was destroyed raises."""

    size: int
    rank: int | None
    device: torch.device
    ranks: tuple[int, ...]
    backend: str | None
    timeout: datetime.timedelta | None

    def __init__(self, group, size: int, rank: int | None,
                 device: torch.device, ranks: tuple[int, ...],
                 backend: str | None, control=None,
                 timeout: datetime.timedelta | None = None):
        for name, value in (("_group", _borrow(group)), ("size", size),
                            ("rank", rank), ("device", device),
                            ("ranks", ranks), ("backend", backend),
                            ("_control", _borrow(control)),
                            ("timeout", timeout)):
            object.__setattr__(self, name, value)

    @property
    def group(self):
        return _lend(self._group, "group")

    @property
    def control(self):
        return _lend(self._control, "control group")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size}

    @property
    def signature(self) -> tuple:
        """What a dispatch on this mesh compiles against, beside its axis:
        the axis size, this rank's place on it and the backend."""
        return (self.size, self.rank, self.backend)

    def check_device(self, device=None) -> torch.device:
        """This rank's device; ``device``, when given, must name it."""
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{self.device} for this rank")
        return self.device

    def local_rank(self) -> int:
        """This process's place on the axis; raises outside the mesh."""
        if self.rank is None:
            raise ValueError(
                f"this process holds no rank of the mesh over global ranks "
                f"{list(self.ranks)}; it cannot dispatch on it")
        return self.rank

    def check_control(self) -> None:
        """Raise unless a mesh of several ranks has its control group."""
        if self.size > 1 and self.control is None:
            raise ValueError(
                f"a mesh of {self.size} ranks needs its control group; make "
                f"it with make_data_mesh under an initialized process group")

    def agree(self, error: BaseException | None) -> None:
        """Every rank's verdict on a step it just ran locally (``error`` is
        None when it succeeded), agreed on the control group before any
        rank goes on to a collective that needs every rank's part.

        One flag all-reduce (the lowest failing rank, or the axis size);
        when a rank failed, that rank broadcasts its message and every rank
        raises the same `RankDispatchError`. On one rank ``error`` is
        raised as it is, and nothing is exchanged."""
        if self.size == 1:
            if error is not None:
                raise error
            return
        import torch.distributed as dist

        self.check_control()
        flag = torch.tensor([self.size if error is None
                             else self.local_rank()], dtype=torch.int64)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.control)
        first = int(flag[0])
        if first == self.size:
            return
        message = [None if error is None
                   else f"{type(error).__name__}: {error}"]
        dist.broadcast_object_list(message, src=self.ranks[first],
                                   group=self.control)
        raise RankDispatchError(first, message[0]) from error


def _borrow(group):
    """A weak reference to a process group; anything else (None, a rank's
    non-member marker) as it is."""
    if group is None:
        return None
    import torch.distributed as dist

    if dist.is_available() and isinstance(group, dist.ProcessGroup):
        return weakref.ref(group)
    return group


def _lend(held, what: str):
    if not isinstance(held, weakref.ref):
        return held
    group = held()
    if group is None:
        raise RuntimeError(f"the mesh's {what} was destroyed "
                           f"(torch.distributed.destroy_process_group)")
    return group


def resolve_shard(shard, axis: str = "data") -> tuple[DataMesh, str]:
    """``mesh`` or ``(mesh, axis)`` → (mesh, axis), validated."""
    mesh, axis = shard if isinstance(shard, tuple) else (shard, axis)
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"expected a DataMesh (launch.mesh.make_data_mesh) "
                        f"or (mesh, axis), got {type(mesh).__name__}")
    if axis not in mesh.shape:
        raise ValueError(
            f"shard axis {axis!r} not in mesh axes {tuple(mesh.shape)}")
    return mesh, axis


def make_data_mesh(num_devices: int | None = None, *, device=None,
                   timeout=None) -> DataMesh:
    """1-D ``data`` mesh over the first ``num_devices`` ranks (default: all).

    With `torch.distributed` initialized, the mesh spans the first
    ``num_devices`` ranks of the world, one device each: ``cuda:LOCAL_RANK``
    under NCCL (``LOCAL_RANK`` defaults to the global rank), the CPU under
    gloo. Every rank of the world must call this, since a group of fewer
    ranks is made by the collective ``new_group``; a rank outside the mesh
    gets one it cannot dispatch on. Without a process group the mesh is this
    process alone, on ``resolve_device(device)``. ``timeout`` (a
    `datetime.timedelta`) bounds the collectives of a group of fewer ranks
    than the world (default: the world's); the whole world's mesh uses the
    world's group, with its own timeout. At more than one rank a gloo
    control group over the same ranks, with that timeout, is made too (a
    group of its own under gloo as well, so the CPU runs what NCCL ranks
    run). Any size works; the butterfly combine folds non-power-of-two
    axes."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if num_devices not in (None, 1):
            raise ValueError(f"num_devices={num_devices} outside [1, 1]")
        return DataMesh(group=None, size=1, rank=0,
                        device=resolve_device(device), ranks=(0,),
                        backend=None)
    world = dist.get_world_size()
    n = world if num_devices is None else num_devices
    if not 1 <= n <= world:
        raise ValueError(f"num_devices={n} outside [1, {world}]")
    me = dist.get_rank()
    backend = str(dist.get_backend())
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", me))
        if not 0 <= local < torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK={local} names no card of this "
                             f"host ({torch.cuda.device_count()} cards)")
        rank_device = torch.device("cuda", local)
    else:
        rank_device = torch.device("cpu")
    if device is not None and resolve_device(device) != rank_device:
        raise ValueError(f"device {device} is not this rank's device "
                         f"{rank_device} under {backend}")
    ranks = tuple(range(n))
    if timeout is None:
        timeout = _world_timeout(backend)
    group = dist.group.WORLD if n == world else dist.new_group(
        list(ranks), timeout=timeout)
    control = None if n == 1 else dist.new_group(
        list(ranks), timeout=timeout, backend="gloo")
    return DataMesh(group=group, size=n, rank=me if me < n else None,
                    device=rank_device, ranks=ranks, backend=backend,
                    control=control, timeout=timeout)


def _world_timeout(backend: str) -> datetime.timedelta:
    """The timeout the world's group was made with (torch's default for the
    backend when the group does not say)."""
    import torch.distributed as dist

    device = torch.device("cuda" if backend == "nccl" else "cpu")
    try:
        return dist.group.WORLD._get_backend(device).options._timeout
    except (AttributeError, RuntimeError):
        return datetime.timedelta(minutes=10 if backend == "nccl" else 30)


def serving_batch_capacity(b: int, *, axis_size: int = 1) -> int:
    """Bucketed request-batch capacity for a live batch of ``b`` requests.

    The next power of two, rounded up to a multiple of the serving mesh's
    ``data`` axis (``axis_size``; 1 on one card), so the engine's cache and
    its captured graphs key on a handful of batch *buckets* instead of every
    live batch size, and a sharded dispatch never re-pads. B=0 has no
    trailing request to repeat; it keeps its own (empty) signature.
    """
    if b <= 0:
        return 0
    cap = next_pow2(b)
    if axis_size > 1:
        cap = -(-cap // axis_size) * axis_size
    return cap


def make_production_mesh(*, multi_pod: bool = False):
    """The LM scaffolding's production mesh — not ported yet (ROADMAP.md,
    A14.6)."""
    raise NotImplementedError("make_production_mesh is not ported yet "
                              "(ROADMAP.md, A14.6)")


def make_host_mesh(model: int = 1, device=None) -> DataMesh:
    """The LM trainer's mesh: one rank on ``device`` (the card unless the
    caller names another), ``make_data_mesh(1, device=device)``. A
    ``model`` axis of more than one rank (tensor parallelism) needs the
    sharding rules, not ported yet (ROADMAP.md, A14.6)."""
    if model != 1:
        raise NotImplementedError(
            f"make_host_mesh(model={model}): tensor parallelism needs the "
            "sharding rules, not ported yet (ROADMAP.md, A14.6)")
    return make_data_mesh(1, device=device)
