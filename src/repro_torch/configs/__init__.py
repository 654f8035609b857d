"""Architecture registry: the 10 assigned archs (+ reduced smoke variants)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from .shapes import SHAPES, ShapeSpec  # noqa: F401

_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-tiny": "whisper_tiny",
    "arctic-480b": "arctic_480b",
    "mixtral-8x22b": "mixtral_8x22b",
    "minicpm-2b": "minicpm_2b",
    "command-r-35b": "command_r_35b",
    "granite-3-8b": "granite_3_8b",
    "qwen3-8b": "qwen3_8b",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_NAMES: list[str] = list(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Which (arch x shape) dry-run cells run; skips per the task spec."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; skipped for "
                       "pure full-attention archs (see DESIGN.md "
                       "§Arch-applicability)")
    return True, ""
