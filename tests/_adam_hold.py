"""Hold one AdamW step of two float32 backends to each other.

Two backends' float32 gradients agree to rounding: the callers hold them
to 1e-6 of a leaf's largest, and the orthogonalized ones to 4e-5 (the
orthogonal update multiplies the rounding by each matrix's condition
number). Adam's update m̂/(√v̂ + eps) is flat in a large
gradient and jumps at 0: an element whose gradient is within that rounding
of 0 (a lone token's embedding row, an orthogonalized entry near 0) steps a
whole ``lr`` one way in one backend and the other way in the other. So two
backends cannot be held side by side through several Adam steps, and one
step is held at the plain bound plus the gradient's own tolerance carried
through the update.

`hold_adam_step` compares one step taken by both from the same state.
Trees are flat dicts ``{leaf path: numpy array}`` in the JAX package's
stacked layout (`flat` of `repro_torch.models.weights.params_to_numpy` /
``opt_state_to_numpy``). Used by the CPU parity tests, the GPU tests and
``chip_smoke.py`` phase 11c; numpy only.
"""

import numpy as np


def flat(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + str(key)] = np.asarray(value)
    return out


def column_signs(ref, got):
    """±1 per column of Q as ``orthogonalize`` forms it from this stacked
    leaf (a 2-D leaf or each matrix of a 3-D one, the wide ones
    transposed): −1 where ``got``'s orthogonalized gradient is the negative
    of ``ref``'s, broadcast to the leaf's shape. Q = G·R⁻¹ keeps the sign
    R's Householder pivot gave each column, and a pivot within rounding of
    0 gives either sign."""
    if ref.ndim not in (2, 3) or (ref.ndim == 2 and min(ref.shape) < 2):
        return np.ones_like(ref)
    axis = -2 if ref.shape[-2] >= ref.shape[-1] else -1
    dot = np.sum(ref * got, axis=axis, keepdims=True)
    return np.broadcast_to(np.where(dot < 0, -1.0, 1.0), ref.shape)


def hold_adam_step(got, before, after, *, step, lr, b1, b2, eps, tau,
                   orthogonal=False, rtol=2e-4, atol=2e-6):
    """One AdamW step (number ``step``, learning rate ``lr``) from the same
    state ``before``: ``got`` against the reference ``after``, each a dict
    ``{"params", "mu", "nu"}`` of flat trees (``before`` needs ``mu`` and
    ``nu``). Held at ``rtol`` and ``atol`` plus the gradient's tolerance
    ``tau`` (of each leaf's largest, δg) carried through the update: a
    parameter may differ by as much as its update varies over
    [g − δg, g + δg] (0 included when it lies there), g the clipped
    gradient the reference's moments give, (mu − b1·mu_prev) / (1 − b1);
    mu by (1 − b1)·δg, nu by (1 − b2)·2(|g| + δg)·δg. With the orthogonal
    update, a column of Q that came out with the other sign is held to the
    reference's step taken with −g there. Raises AssertionError naming the
    leaf; returns ``{"flipped": elements in such columns, "small":
    elements with 0 < |g| ≤ δg}``."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    out = {"flipped": 0, "small": 0}
    for key, want in after["params"].items():
        f = {name: tree[key].astype(np.float64) for name, tree in (
            ("p", got["params"]), ("mu", got["mu"]), ("nu", got["nu"]),
            ("mu1", after["mu"]), ("nu1", after["nu"]),
            ("mu0", before["mu"]), ("nu0", before["nu"]))}
        want = want.astype(np.float64)

        def update(g):
            m = (b1 * f["mu0"] + (1 - b1) * g) / bc1
            v = (b2 * f["nu0"] + (1 - b2) * g * g) / bc2
            return lr * m / (np.sqrt(v) + eps)

        g = (f["mu1"] - b1 * f["mu0"]) / (1 - b1)
        if orthogonal:
            sign = column_signs(g, (f["mu"] - b1 * f["mu0"]) / (1 - b1))
            out["flipped"] += int((sign < 0).sum())
            want = want + update(g) - update(sign * g)
            g = sign * g
        dg = tau * np.abs(g).max()
        near0 = np.abs(g) <= dg
        out["small"] += int((near0 & (g != 0)).sum())
        u = update(g)
        trial = [g + c * dg for c in np.linspace(-1, 1, 9)]
        trial += [np.where(near0, c, g) for c in (-1e-30, 1e-30)]
        slack = {"p": np.max([np.abs(update(x) - u) for x in trial], axis=0),
                 "mu": (1 - b1) * dg,
                 "nu": (1 - b2) * 2 * (np.abs(g) + dg) * dg}
        mu1 = b1 * f["mu0"] + (1 - b1) * g
        for name, ref in (("p", want), ("mu", mu1), ("nu", f["nu1"])):
            err = np.abs(f[name] - ref)
            bad = err > atol + rtol * np.abs(ref) + slack[name]
            if bad.any():
                raise AssertionError(
                    f"{key} {name}: {int(bad.sum())} elements beyond the "
                    f"bound, max |diff| {float(err[bad].max()):.3e}")
    return out
