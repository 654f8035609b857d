"""Numerics sanitizer: sampled float64 shadow dispatch + NaN/Inf tripwires.

The paper's accuracy claim is that Figaro's rounding errors relative to
classical QR scale with the **database size** (sum of relation rows), not
the join output size. This module turns that claim into a runtime
assertion: on a sampled subset of engine dispatches it re-runs the same
request through the same plan in float64 (a *shadow* dispatch, on the same
device, eagerly: never captured into a CUDA graph) and compares a
sign-invariant functional of the two results against the analytic budget

    rel_err  <=  eps(primary dtype) * slack * database_rows

mirroring `core.figaro.assembly_traffic`'s style of analytic accounting —
the model counts the work (one Givens chain per column, length ~ database
rows), not the constants, so ``slack`` carries the usual backward-stability
engineering factor.

Comparisons are sign/rotation-invariant per kind: QR and R₀ compare Gram
matrices RᵀR (R is unique only up to row signs), SVD compares singular
values, PCA compares explained variances, least-squares compares the
(unique) coefficient vector. Shadow dispatches are marked thread-local so
they never recurse, never bump the engine's signature-miss counters, and
never feed the retrace sanitizer.

A copy of the JAX package's `repro.sanitizer.numerics` for tensors: torch
always has float64, so every floating primary dtype but float64 is
shadowable. This is the only sanitizer file that imports torch.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ._state import STATE

_lock = threading.Lock()
_dispatch_counts: collections.Counter = collections.Counter()
_events: "collections.deque" = collections.deque(maxlen=256)


def reset() -> None:
    with _lock:
        _dispatch_counts.clear()
        _events.clear()


def events() -> list[dict]:
    with _lock:
        return [dict(e) for e in _events]


def _sample(kind: str) -> bool:
    """First dispatch of each kind always shadows; then every Nth."""
    with _lock:
        _dispatch_counts[kind] += 1
        n = _dispatch_counts[kind]
    every = max(int(STATE.sample_every), 1)
    return n == 1 or n % every == 0


class _Shadow:
    __slots__ = ("kind", "plan", "host", "options", "primary", "device")

    def __init__(self, kind, plan, host, options, primary, device) -> None:
        self.kind = kind
        self.plan = plan
        self.host = host
        self.options = options
        self.primary = primary
        self.device = device


def prepare_shadow(engine, kind: str, plan, data, options,
                   device) -> _Shadow | None:
    """Called from ``FigaroEngine._dispatch`` with the request as the caller
    gave it, before it is cast to the dispatch's dtype (the shadow casts the
    same values to float64). Returns a shadow token, or None when this
    dispatch is not sampled / not shadowable."""
    if STATE.shadow_active():
        return None
    if not _sample(kind):
        return None
    primary = options.get("dtype", torch.float32)
    if not primary.is_floating_point or primary == torch.float64:
        return None
    host = None if data is None else tuple(data)
    return _Shadow(kind, plan, host, dict(options), primary, device)


def database_rows(host, plan) -> int:
    """Σ relation rows — the paper's database size (each data leaf is
    [..., m_i, n_i]; the leading batch axis, if any, does not multiply the
    per-pipeline rotation count)."""
    leaves = host if host is not None else tuple(plan.data)
    return int(sum(int(np.shape(d)[-2]) for d in leaves)) or 1


def error_budget(primary, db_rows: int) -> float:
    return float(torch.finfo(primary).eps) * STATE.numerics_slack * db_rows


def _host64(t) -> np.ndarray:
    return t.detach().to("cpu", dtype=torch.float64).numpy()


def _comparable(kind: str, out) -> np.ndarray:
    """Sign/rotation-invariant functional of a dispatch result."""
    if kind.startswith(("r0", "qr")):
        r = _host64(out)
        return np.matmul(np.swapaxes(r, -1, -2), r)  # Gram: RᵀR
    if kind.startswith("svd"):
        return _host64(out[0])  # singular values
    if kind.startswith("pca"):
        return _host64(out.explained_variance)
    if kind.startswith("least_squares"):
        return _host64(out[0])  # beta
    raise ValueError(f"no numerics comparison for kind={kind!r}")


def relative_error(primary_out, shadow_out, kind: str) -> float:
    a = _comparable(kind, primary_out)
    b = _comparable(kind, shadow_out)
    denom = max(float(np.linalg.norm(b)), np.finfo(np.float64).tiny)
    return float(np.linalg.norm(a - b)) / denom


def _leaves(out) -> list:
    """The tensors of a dispatch result: a tensor, a tuple of them, or a
    `PCAResult` (its fields in declaration order)."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    fields = getattr(out, "__dataclass_fields__", None)
    if fields is not None:
        return [t for f in fields for t in _leaves(getattr(out, f))]
    return [out]


def _check_finite(kind: str, out) -> None:
    for i, leaf in enumerate(_leaves(out)):
        if not leaf.is_floating_point():
            continue
        arr = _host64(leaf)
        if not np.all(np.isfinite(arr)):
            bad = int(arr.size - np.count_nonzero(np.isfinite(arr)))
            STATE.add_finding(
                "numerics",
                f"non-finite values in kind={kind} output leaf {i} "
                f"({bad}/{arr.size} entries)",
                details={"kind": kind, "leaf": i, "bad": bad},
                dedupe_key=("numerics-nonfinite", kind, i),
            )


def after_dispatch(engine, shadow: _Shadow | None, out) -> None:
    """Called from ``_dispatch`` after the primary result."""
    if shadow is None:
        return
    _check_finite(shadow.kind, out)
    opts = dict(shadow.options)
    opts["dtype"] = torch.float64
    STATE.set_shadow(True)
    try:
        ref = engine._dispatch(shadow.kind, shadow.plan, shadow.host,
                               device=shadow.device, **opts)
    finally:
        STATE.set_shadow(False)
    err = relative_error(out, ref, shadow.kind)
    db_rows = database_rows(shadow.host, shadow.plan)
    budget = error_budget(shadow.primary, db_rows)
    with _lock:
        _events.append({"kind": shadow.kind, "rel_err": err,
                        "budget": budget, "db_rows": db_rows,
                        "dtype": str(shadow.primary).split(".")[-1]})
    if err > budget:
        STATE.add_finding(
            "numerics",
            f"kind={shadow.kind} {str(shadow.primary).split('.')[-1]} "
            f"error {err:.3e} "
            f"exceeds database-size budget {budget:.3e} "
            f"(eps*{STATE.numerics_slack:g}*{db_rows} rows)",
            details={"kind": shadow.kind, "rel_err": err, "budget": budget,
                     "db_rows": db_rows},
            dedupe_key=("numerics-budget", shadow.kind),
        )
