"""Partition specs, placements and the collectives of sharded training."""

from .rules import (P, PartitionSpec, batch_specs, data_axes,  # noqa: F401
                    param_shardings, param_specs)
