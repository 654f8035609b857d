"""The LM scaffolding's dense attention path: configuration, layers, the
decoder stack and its loss (see `transformer`)."""

from .config import LayerSpec, MambaConfig, ModelConfig, MoEConfig, RWKVConfig  # noqa: F401
from . import layers, transformer, weights  # noqa: F401
