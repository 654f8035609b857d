"""Train/eval steps of the LM (`step`) and its serving entry points
(`serve`)."""

from .step import TrainState, init_state, make_train_step, make_eval_step  # noqa: F401
