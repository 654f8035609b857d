"""Relational dataset generators (`relational`) and the LM's token pipeline
(`pipeline`), copies of the JAX package's."""

from .pipeline import TokenPipeline  # noqa: F401
from . import relational  # noqa: F401
