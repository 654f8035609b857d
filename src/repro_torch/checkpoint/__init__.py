"""Async, atomic checkpoints in the JAX package's layout (`manager`)."""

from .manager import CheckpointManager  # noqa: F401
