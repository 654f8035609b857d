"""Rule registry: one module per rule family, aggregated here."""

from __future__ import annotations

from ..framework import Rule
from .capture_effects import CaptureEffectsRule
from .capture_sync import CaptureSyncRule
from .donation import DonationRule
from .dtype_drift import DtypeDriftRule
from .graph_key import GraphKeyRule
from .import_boundary import ImportBoundaryRule
from .kernel_launch import KernelLaunchRule
from .lock_discipline import LockDisciplineRule
from .san_routing import SanRoutingRule
from .slab_layout import SlabLayoutRule
from .thread_escape import ThreadEscapeRule

__all__ = ["all_rules", "GraphKeyRule", "DtypeDriftRule", "KernelLaunchRule",
           "LockDisciplineRule", "ThreadEscapeRule", "SanRoutingRule",
           "ImportBoundaryRule", "CaptureSyncRule", "CaptureEffectsRule",
           "DonationRule", "SlabLayoutRule"]


def all_rules() -> list[Rule]:
    """Fresh rule instances (rules may keep per-run state)."""
    return [GraphKeyRule(), DtypeDriftRule(), KernelLaunchRule(),
            LockDisciplineRule(), ThreadEscapeRule(), SanRoutingRule(),
            ImportBoundaryRule(), CaptureSyncRule(), CaptureEffectsRule(),
            DonationRule(), SlabLayoutRule()]
