"""One run of one cell: set-up, warm-up, the window, the metrics, the check.

`run_cell` takes the cell's configuration, traffic mix and limits by name
from the manifest. It draws the tables from the seed, ingests and joins
them as drawn through the port's public surface
(`repro_torch.figaro.Session`), lets
the traffic's driver warm up every shape the window uses, and then runs the
driver's closed loop for the window. The tables' prepared copy (see
`figbench.data.prepare`), which only the reference reads, is made after the
window. With ``traced`` the window runs under the profiler (see `figbench.trace`).
Once the window has closed it reads the peak of device memory, refuses to
go on if JAX or the JAX package was loaded, frees the port's state, and
then holds every answer to the plain reference (`figbench.reference`),
worked out again from the tables and feature sets the benchmark drew.

A run with ``control`` is the check's control: the port with its own lower
precision switched on (TF32 matmuls where the cell computes in float32,
float32 where it computes in float64). The benchmark's own runs never set it.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

from figbench import roofline, trace
from figbench.data import draw_tables, prepare, tree_stats
from figbench.manifest import Manifest
from figbench.reference.checks import KIND_NUMBERS, check_answer
from figbench.reference.join import Join

__all__ = ["run_cell", "ImportBoundary", "FORBIDDEN"]

#: Top-level module names that may not be loaded in a run: JAX, its
#: libraries, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: Seconds an answer may come after the window closes and still count.
GRACE_S = 60.0


class ImportBoundary(RuntimeError):
    pass


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver sees of the run."""
    ds: object
    drawn: dict  # the tables as drawn, before reduction
    config: dict
    traffic: dict
    seed: int
    device: object
    dtype: object
    order: tuple
    spans: list
    launches: object


@dataclasses.dataclass
class Record:
    """What a metric's reader sees of the run (see ``metrics/``)."""
    setup_s: float
    setup: dict
    seconds: float
    completed: int
    latencies_ms: list
    requests: int = 0
    window: tuple = (0, 0)
    device_events: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    per_dispatch: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    dtype: str = "float32"


def _numpy_answer(kind: str, answer):
    """An answer of the port as numpy arrays: R; (s, Vᵀ); (components,
    explained variance, mean); the coefficients."""
    def cpu(x):
        return x.detach().double().cpu().numpy()

    if kind == "qr":
        return cpu(answer)
    if kind == "svd":
        return tuple(cpu(x) for x in answer)
    if kind == "pca":
        return (cpu(answer.components), cpu(answer.explained_variance),
                cpu(answer.mean))
    if kind == "lsq":
        return cpu(answer[0])
    raise ValueError(kind)


def _counters(engine, launches) -> dict:
    return {"launches": launches(), "traces": engine.trace_count(),
            "captures": engine.capture_count()}


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None,
             control: bool = False, manifest: Manifest | None = None,
             config: dict | None = None, log=print) -> dict:
    """Run ``cell`` once and return the result line's fields, with the
    compared numbers and their limits under ``checks``."""
    import torch

    from repro_torch import figaro
    from repro_torch.kernels import _platform

    t_start = time.perf_counter() if t_start is None else t_start
    m = manifest or Manifest()
    spec = m.cell(cell)
    config = config or m.config(spec["config"])
    traffic = m.traffic(spec["traffic"])
    limits = m.limits(cell)
    device = torch.device(device)
    on_card = device.type == "cuda"
    dtype_name = traffic["dtype"]
    tf32 = False
    if control:  # the port's own next precision down
        if dtype_name == "float32":
            tf32 = True
        else:
            dtype_name = "float32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    dtype = getattr(torch, dtype_name)

    phases = {"imports_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    drawn = draw_tables(config, seed)
    phases["draw_s"] = time.perf_counter() - t0
    session = figaro.Session(device=device, **config["session"])
    t0 = time.perf_counter()
    ds = session.ingest({n: (t.keys, t.data, list(t.columns))
                         for n, t in drawn.items()}).join(
        [tuple(e) for e in config["edges"]], root=config["root"])
    phases["join_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ = ds.plan
    phases["plan_s"] = time.perf_counter() - t0
    names = tuple(ds.columns)
    order = tuple(dict.fromkeys(n.split(".", 1)[0] for n in names))
    if sorted(order) != sorted(drawn):
        raise RuntimeError(f"the dataset's relations {order} are not the "
                           f"configuration's {sorted(drawn)}")
    spans: list = []
    ctx = Context(ds=ds, drawn=drawn, config=config, traffic=traffic,
                  seed=seed, device=device, dtype=dtype, order=order,
                  spans=spans, launches=_platform.launch_counts)
    t0 = time.perf_counter()
    driver = m.driver(traffic["driver"])(ctx)
    phases["driver_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_dispatch = driver.warm()
    if on_card:
        torch.cuda.synchronize(device)
    phases["warm_s"] = time.perf_counter() - t0
    log("set-up: " + ", ".join(f"{k[:-2]} {v:.2f} s"
                               for k, v in phases.items()))
    window = min(seconds, traffic.get("trace_seconds", seconds)) \
        if traced else seconds
    before = _counters(session.engine, _platform.launch_counts)
    cap = trace.Capture() if traced else None
    if cap is not None:
        cap.__enter__()
    try:
        records, w0 = driver.run(window, GRACE_S)
        if on_card:
            torch.cuda.synchronize(device)
        w_end = time.perf_counter_ns()
    finally:
        if cap is not None:
            cap.__exit__(*sys.exc_info())
    after = _counters(session.engine, _platform.launch_counts)
    tables = prepare(config, drawn)  # the reference's, not set-up
    driver_sets = driver.value_sets(tables)
    driver.close()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise ImportBoundary(f"loaded after the window: {found}")

    setup_s = (w0 / 1e9) - t_start
    stop = w0 + int(window * 1e9)
    done = [r for r in records if r["error"] is None and r["t1"] <= stop]
    rec = Record(setup_s=setup_s, setup=phases,
                 seconds=window, completed=len(done),
                 latencies_ms=[(r["t1"] - r["t0"]) / 1e6 for r in done],
                 requests=sum(r["error"] is None for r in records),
                 window=(w0, w_end), spans=spans,
                 counters={"before": before, "after": after},
                 per_dispatch=per_dispatch, dtype=dtype_name)
    if traced:
        rec.device_events = cap.device
        stats = tree_stats(tables, config["root"], config["edges"])
        rec.work = {"node_pass": roofline.node_pass_work(stats, dtype_name),
                    "panel": roofline.panel_work(stats, dtype_name)}
    metrics = {}
    for metric in m.metrics(cell, traced):
        value = m.reader(metric["name"])(rec)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value),
                                       "unit": metric["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"attempted": len(records),
              "failed": sum(r["error"] is not None for r in records),
              "metrics": metrics, "device": device_info}
    if traced:
        events = trace.in_window(cap.device, w0, w_end)
        device_info["busy_s"] = trace.busy_ns(events) / 1e9
        device_info["window_s"] = (w_end - w0) / 1e9
        result["breakdown"] = trace.breakdown(cap.device, w0, w_end, spans)
    for r in records:
        if r["error"] is None:
            r["answer"] = _numpy_answer(r["kind"], r["answer"])

    # The port's state goes before the reference runs on the card.
    del driver, ctx, ds, session, cap
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    join = Join(tables, config["root"], config["edges"], device=device)
    refs = join.gram(driver_sets)
    worst: dict = {}
    for r in records:
        if r["error"] is not None:
            continue
        got = check_answer(r["kind"], r["answer"], names, join.columns,
                           refs[r["key"]], k=r.get("k"),
                           label=config["label"])
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v if math.isfinite(v)
                           else math.inf)
    log(f"reference: {time.perf_counter() - t0:.1f} s for "
        f"{result['attempted'] - result['failed']} answers")
    kinds = [traffic["kind"]] if "kind" in traffic else [
        c["kind"] for c in traffic["calls"]]
    checks = {"failed": {"value": result["failed"], "limit": 0}}
    for n in dict.fromkeys(n for k in kinds for n in KIND_NUMBERS[k]):
        value = worst.get(n, math.inf)
        checks[n] = {"value": value if math.isfinite(value) else None,
                     "limit": limits[n]}
    correct = bool(records) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return {"correct": correct, **result, "checks": checks}
