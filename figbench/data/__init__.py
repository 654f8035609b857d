"""The benchmark's data: tables made from a configuration and a seed (numpy only)."""

from figbench.data.tables import (Table, draw_tables, feature_sets,  # noqa: F401
                                  make_tables, orient, prepare, reduce,
                                  resolve, tree_stats)
