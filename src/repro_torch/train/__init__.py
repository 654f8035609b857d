"""Train/eval steps of the LM (the eval step so far; see `step`)."""

from .step import make_eval_step  # noqa: F401
