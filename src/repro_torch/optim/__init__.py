"""The LM's optimizer: AdamW, learning-rate schedules, int8 gradient
compression and the TSQR-orthogonalized update (the JAX package's
``optim/``)."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedules import warmup_cosine, wsd  # noqa: F401
from .compression import compressed_psum, init_residual  # noqa: F401
from .orthogonal import orthogonalize, orthogonalized_update  # noqa: F401
