"""Serving kinds of the port, validated in one place.

The JAX package's `repro.train.async_serve` holds its async serving server
(request queue, futures, pipelined dispatch). The port has not got that
server yet (ROADMAP.md, item A11); what the dataset surface already needs of
the module is the list of serving kinds and its eager validator, copied here
so ``JoinDataset.serve(kind=...)`` rejects a bad kind before anything else,
as the JAX package does.
"""

from __future__ import annotations

__all__ = ["SERVE_KINDS", "validate_serve_kind"]

#: The serving kinds every serving surface supports (`Session.serve`,
#: `JoinDataset.serve`) — validated eagerly, in one place.
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
