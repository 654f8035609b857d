"""The operation counts, the trace arithmetic and every metric's reader, on
synthetic records and device event lists."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from figbench import roofline, trace  # noqa: E402
from figbench.harness import Record  # noqa: E402
from figbench.manifest import Manifest  # noqa: E402

MANIFEST = Manifest()
MS = 1_000_000  # ns

STATS = {"N": 3, "nodes": {
    "R": {"m": 100, "n": 1, "K": 90, "w": 3},
    "S": {"m": 10, "n": 2, "K": 10, "w": 2}}}


def test_operation_counts():
    nbytes, flops = roofline.node_pass_work(STATS, "float32")
    assert nbytes == 4 * (2 * 100 * 1 + 90 * 3 + 2 * 10 * 2 + 10 * 2)
    assert flops == 8 * (100 + 20)
    nbytes, flops = roofline.panel_work(STATS, "float64")
    m = 100 + 90 + 10 + 10
    assert nbytes == 8 * (m * 3 + 9)
    assert flops == int(2 * m * 9 - 2 * 27 / 3)
    assert roofline.least_seconds((3.35e12, 0), "float32") == 1.0
    assert roofline.least_seconds((0, 134e12), "float64") == 2.0


def _record(events, window=(0, 100 * MS), **kw):
    base = dict(setup_s=50.0, setup={"join_s": 30.0, "plan_s": 10.0},
                seconds=20.0, completed=40, latencies_ms=[float(i)
                                                          for i in range(1, 101)],
                requests=2, window=window, device_events=events,
                spans=[("client.wait", 0, 60 * MS),
                       ("client.submit", 50 * MS, 100 * MS)],
                counters={"before": {"launches": {"node_fused": 10},
                                     "traces": 3, "captures": 2},
                          "after": {"launches": {"node_fused": 30},
                                    "traces": 3, "captures": 2}},
                per_dispatch={"node_fused": 5},
                work={"node_pass": (int(3.35e12 * 1e-3), 0),
                      "panel": (int(3.35e12 * 2e-3), 0)},
                dtype="float32")
    base.update(kw)
    return Record(**base)


NODE = "void segscan::seg_kernel<float, 0>(segscan::Params<float>)"
PANEL = "void panel_qr_reg_kernel<float, 32, false>(Args)"
EVENTS = [
    ("Memcpy HtoD (Pinned -> Device)", 0, 5 * MS),
    (NODE, 2 * MS, 3 * MS),
    ("nf_prep(...)", 3 * MS, 4 * MS),
    (PANEL, 10 * MS, 12 * MS),
    ("gemm", 12 * MS, 15 * MS),
    (PANEL, 15 * MS, 20 * MS),
    (NODE, 40 * MS, 41 * MS),
    (PANEL, 50 * MS, 55 * MS),
    ("late kernel", 90 * MS, 110 * MS),
]


def read(name, rec):
    return MANIFEST.reader(name)(rec)


def test_trace_arithmetic():
    assert trace.merged(EVENTS[:3]) == [[0, 5 * MS]]
    assert trace.busy_ns(trace.in_window(EVENTS, 0, 100 * MS)) \
        == (5 + 10 + 1 + 5 + 10) * MS
    idle = trace.gaps(EVENTS, 0, 100 * MS)
    assert idle[0] == (5 * MS, 10 * MS) and idle[-1] == (55 * MS, 90 * MS)
    labels = dict(trace.label_gaps([(0, 10 * MS), (55 * MS, 59 * MS),
                                    (80 * MS, 90 * MS)], _record([]).spans))
    assert "client.wait" in labels and "client.submit" in labels
    assert "client.submit+client.wait" in labels
    out = trace.breakdown(EVENTS, 0, 100 * MS, _record([]).spans, top=3)
    assert out["device_ops"][0] == [PANEL, 0.012]
    assert len(out["device_ops"]) == 3 and len(out["idle_gaps"]) == 3
    assert out["idle_gaps"][0] == ["client.submit", 0.035]


def test_every_reader_on_a_synthetic_trace():
    rec = _record(EVENTS)
    assert read("setup_s", rec) == 50.0
    assert read("requests_per_s", rec) == 2.0
    assert read("latency_p95_ms", rec) == pytest.approx(95.05)
    assert read("serve.latency_p95_ms", rec) == pytest.approx(95.05)
    assert read("setup.join_s", rec) == 30.0
    assert read("setup.plan_s", rec) == 10.0
    assert read("engine.misses", rec) == 0.0
    assert read("serve.batch_mean", rec) == 2 / (20 / 5)
    # copies 5 ms of 31 ms busy
    assert read("stage.h2d_share", rec) == pytest.approx(100 * 5 / 31)
    assert read("device.idle_share", rec) == pytest.approx(69.0)
    # node pass: 1 ms least a request, two requests, 3 ms of its kernels
    assert read("node_fused_roofline", rec) == pytest.approx(100 * 2 / 3)
    # panels: dispatch one 10..20 ms, dispatch two 50..55 ms; 2 ms a request
    assert read("panel_qr_roofline", rec) == pytest.approx(100 * 4 / 15)


def test_a_reader_finds_nothing_where_nothing_ran():
    rec = _record([("late kernel", 90 * MS, 95 * MS)])
    for name in ("node_fused_roofline", "panel_qr_roofline",
                 "stage.h2d_share"):
        assert read(name, rec) is None
    assert read("device.idle_share", rec) == pytest.approx(95.0)
    assert read("device.idle_share", _record([])) is None
    assert read("serve.batch_mean", _record([], per_dispatch={})) is None
