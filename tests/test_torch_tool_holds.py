"""The four-card training hold's check of the split against the one card
(``tools/train_mesh_cards.py``: `split_faults`), on planted errors."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "train_mesh_cards", REPO / "tools" / "train_mesh_cards.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("planted", [None, "wk", "w_down"])
def test_a_leaf_five_times_the_one_cards_error_fails_the_hold(planted):
    """Leaves of a rounding below tau/8 keep the largest split-over-one
    ratio (20x, an error that says nothing); a leaf above tau/8 with 5x
    the one card's error must still be named, and only it."""
    tool = _tool()
    tau = tool.TAU
    g_one = {"wq": tau / 400, "wk": tau / 20, "wv": tau / 20,
             "w_down": tau / 10}
    g_rel = {"wq": tau / 20, "wk": tau / 20, "wv": tau / 20,
             "w_down": tau / 10}
    if planted:
        g_rel[planted] = 5 * g_one[planted]
    faults = tool.split_faults(g_rel, g_one)
    if planted is None:
        assert faults == []
    else:
        assert len(faults) == 1 and faults[0].endswith(f"on {planted}")
        assert "5.00x" in faults[0]
