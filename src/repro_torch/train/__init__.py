"""Train/eval steps of the LM (`step`) and its serving entry points
(`serve`)."""

from .step import (TrainState, init_state, make_eval_step,  # noqa: F401
                   make_train_step, shard_state)
