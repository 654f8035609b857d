"""Serving batch buckets, the one part of the JAX package's
``launch/mesh.py`` that one card needs.

`serving_batch_capacity` picks the request-batch capacity the async serving
queue (`repro_torch.train.async_serve`) dispatches a coalesced micro-batch
at. The meshes of that module are not ported yet: the serving data mesh
(`make_data_mesh`) is ROADMAP item A12, the production and host meshes of
the LM scaffolding (`make_production_mesh`, `make_host_mesh`) item A14.6;
each raises `NotImplementedError` naming its item.
"""

from __future__ import annotations

from repro_torch.core.plan_cache import next_pow2

__all__ = ["serving_batch_capacity", "make_data_mesh",
           "make_production_mesh", "make_host_mesh"]


def serving_batch_capacity(b: int, *, axis_size: int = 1) -> int:
    """Bucketed request-batch capacity for a live batch of ``b`` requests.

    The next power of two, rounded up to a multiple of the serving mesh's
    ``data`` axis (``axis_size``; 1 on one card), so the engine's cache and
    its captured graphs key on a handful of batch *buckets* instead of every
    live batch size. B=0 has no trailing request to repeat; it keeps its own
    (empty) signature.
    """
    if b <= 0:
        return 0
    cap = next_pow2(b)
    if axis_size > 1:
        cap = -(-cap // axis_size) * axis_size
    return cap


def make_data_mesh(num_devices: int | None = None):
    """The serving data mesh — not ported yet (ROADMAP.md, A12)."""
    raise NotImplementedError("make_data_mesh (the serving data mesh) is not "
                              "ported yet (ROADMAP.md, A12)")


def make_production_mesh(*, multi_pod: bool = False):
    """The LM scaffolding's production mesh — not ported yet (ROADMAP.md,
    A14.6)."""
    raise NotImplementedError("make_production_mesh is not ported yet "
                              "(ROADMAP.md, A14.6)")


def make_host_mesh(model: int = 1):
    """The LM scaffolding's host mesh — not ported yet (ROADMAP.md, A14.6)."""
    raise NotImplementedError("make_host_mesh is not ported yet "
                              "(ROADMAP.md, A14.6)")
