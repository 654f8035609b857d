"""The port's figaro-lint (`repro_torch.analysis`): every FGT rule fires on
its bad fixture, stays quiet on its good one (its outs) and honours a line
suppression; the real tree `src/repro_torch` gives no finding with no
baseline; the CLI's exit codes and reports; and the package imports with
torch, numpy, jax and the JAX package blocked."""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import analyze_paths, analyze_source, load_program
from repro_torch.analysis import unused_report
from repro_torch.analysis.rules import all_rules

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
CORE = "src/repro_torch/core/fixture.py"


def _findings(source, path=CORE, rule=None):
    found = analyze_source(textwrap.dedent(source), path, all_rules())
    return [f for f in found if rule is None or f.rule == rule]


def _messages(source, rule, path=CORE):
    return [f.message for f in _findings(source, path, rule)]


# -- FGT002 graph key --------------------------------------------------------

FGT002_BAD = """
    _R = ("dtype", "use_kernel")

    class Engine:
        _STATIC = {
            "r0": ("dtype", "use_kernel"),
            "qr": _R,
            "pca": ("k",) + _R,
        }

        def _body(self, kind, plan, data, options):
            r0 = first(data, use_kernel=options["use_kernel"])
            if kind.startswith("r0"):
                return r0
            return second(r0, method=options["method"])

        def _tail(self, kind, r, options):
            base = kind.removesuffix("_batched")
            if base == "pca":
                return pca(r, k=options["k"], center=options.get("center"))
            return r

        def qr(self, plan, data=None, *, batched=False, dtype=None):
            return self._dispatch("qr_batched" if batched else "qr", plan,
                                  data, dtype=dtype)

        def r0(self, plan, data=None, *, dtype=None):
            return self._dispatch("r0", plan, data, dtype=dtype,
                                  use_kernel=True)
"""

FGT002_GOOD = """
    _R = ("dtype", "use_kernel", "method")

    class Engine:
        _STATIC = {
            "r0": ("dtype", "use_kernel"),
            "qr": _R,
            "pca": ("k", "center") + _R,
        }

        def _body(self, kind, plan, data, options):
            r0 = first(data, use_kernel=options["use_kernel"])
            if kind.startswith("r0"):
                return r0
            return second(r0, method=options["method"])

        def _tail(self, kind, r, options):
            base = kind.removesuffix("_batched")
            if base == "pca":
                return pca(r, k=options["k"], center=options.get("center"))
            return r

        def qr(self, plan, data=None, *, dtype=None, use_kernel=False,
               method="tsqr"):
            return self._dispatch("qr", plan, data, dtype=dtype,
                                  use_kernel=use_kernel, method=method)
"""


def test_fgt002_static_entry_omitting_a_body_option_fires():
    msgs = _messages(FGT002_BAD, "FGT002")
    # `_body` reads method on the qr and pca paths, not on r0's (it returns)
    assert any("`_body` reads option 'method' for kind 'qr'" in m
               for m in msgs), msgs
    assert any("option 'method' for kind 'pca'" in m for m in msgs)
    assert not any("'method' for kind 'r0'" in m for m in msgs)
    # the eager tail's reads key the cache too
    assert any("`_tail` reads option 'center' for kind 'pca'" in m
               for m in msgs)
    assert not any("'k' for kind 'pca'" in m for m in msgs)
    # the public method: a kind missing from the table, an option not passed
    assert any("dispatches kind 'qr_batched'" in m for m in msgs)
    assert any("dispatches 'qr' without option 'use_kernel'" in m
               for m in msgs)
    assert any("option 'use_kernel' of `_STATIC['r0']` is not a keyword "
               "of `r0`" in m for m in msgs)
    assert not any("'dtype'" in m for m in msgs)


def test_fgt002_key_covering_every_read_is_quiet():
    assert _findings(FGT002_GOOD, rule="FGT002") == []


def test_fgt002_option_passed_whole_is_followed_or_reported():
    src = """
        class Engine:
            _STATIC = {"qr": ("dtype",)}

            def _body(self, kind, plan, data, options):
                return self._helper(data, options) + other(options)

            def _helper(self, data, options):
                return data * options["scale"]
    """
    msgs = _messages(src, "FGT002")
    assert any("reads option 'scale'" in m for m in msgs), msgs
    assert any("`other` (passed whole)" in m for m in msgs), msgs


# -- FGT003 dtype drift ------------------------------------------------------

FGT003_BAD = """
    import numpy as np
    import torch

    def f(x):
        y = x.to(torch.float32)
        z = torch.zeros(3, dtype=torch.half)
        return y, z, np.float32, torch.float
"""

FGT003_GOOD = """
    import torch

    CODES = {torch.float32: 1, torch.bfloat16: 2}  # a module-level table

    def f(x, dtype=torch.float32):
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(x.dtype)
        return x.to(acc).to(dtype)
"""


def test_fgt003_fires_on_hardcoded_narrowing():
    msgs = _messages(FGT003_BAD, "FGT003")
    for name in ("torch.float32", "torch.half", "numpy.float32",
                 "torch.float`"):
        assert any(name in m for m in msgs), (name, msgs)


def test_fgt003_quiet_on_defaults_idiom_comparisons_and_tables():
    assert _findings(FGT003_GOOD, rule="FGT003") == []


def test_fgt003_counts_file_rejects_even_the_idiom_and_others_are_out():
    counts = "src/repro_torch/core/counts.py"
    assert _findings(FGT003_GOOD, counts, "FGT003")
    assert _findings(FGT003_BAD, "src/repro_torch/models/m.py",
                     "FGT003") == []
    assert _findings(FGT003_BAD, "src/repro/core/fixture.py",
                     "FGT003") == []


# -- FGT004 kernel launch ----------------------------------------------------

OPS = "src/repro_torch/kernels/thing/ops.py"

FGT004_OPS_BAD = """
    from . import kernel, ref

    def thing(x):
        if x.is_cuda:
            return kernel.thing(x)
        return ref.thing_ref(x)

    def other(x):
        if x.device.type == "cpu":
            return ref.thing_ref(x)
        return kernel.thing(x)

    def unasked(x):
        return kernel.thing(x)
"""

FGT004_OPS_GOOD = """
    from repro_torch.kernels import _platform

    from . import kernel, ref

    def thing(x):
        if _platform.is_cpu(x):
            return ref.thing_ref(x)
        return kernel.thing(x)
"""

FGT004_FALLBACK = """
    from repro_torch.kernels.thing import kernel, ref

    def run(x):
        try:
            return kernel.thing(x)
        except RuntimeError:
            return ref.thing_ref(x)
"""

FGT004_CALLER_FALLBACK = """
    from repro_torch.kernels.node_fused import node_fused_ref

    def pass_one(x):
        from repro_torch.kernels.node_fused import ops as nf_ops
        try:
            return nf_ops.node_fused(x)
        except RuntimeError:
            return node_fused_ref(x)

    def pass_two(x):
        from repro_torch.kernels.panel_qr import panel_qr
        try:
            return panel_qr(x)
        except RuntimeError:
            return None

    def plain(x):
        try:
            return node_fused_ref(x)
        except RuntimeError:
            return None
"""

FGT004_RERAISE = """
    from repro_torch.kernels.thing import kernel

    def run(x):
        try:
            return kernel.thing(x)
        except RuntimeError as e:
            raise RuntimeError(f"thing failed on {x.shape}") from e
"""

FGT004_IMPORT_TIME = """
    import os

    import triton
    from repro_torch.kernels import _build

    LIB = _build.library("thing")
    MODE = os.environ.get("THING_MODE")

    def launch(x):
        import triton.language as tl
        return _build.library("thing"), tl
"""


def test_fgt004_wrapper_choosing_by_its_own_device_test_fires():
    msgs = _messages(FGT004_OPS_BAD, "FGT004", OPS)
    assert any("`thing` tests the device itself (`x.is_cuda`)" in m
               for m in msgs), msgs
    assert any("`other` tests the device itself (`x.device.type`)" in m
               for m in msgs)
    assert any("`unasked` calls its kernel without asking" in m
               for m in msgs)
    assert _findings(FGT004_OPS_GOOD, OPS, "FGT004") == []


def test_fgt004_try_except_falling_back_to_ref_fires():
    msgs = _messages(FGT004_FALLBACK, "FGT004")
    assert any("launches a kernel" in m and "fall back" in m
               for m in msgs), msgs
    assert _findings(FGT004_RERAISE, rule="FGT004") == []


def test_fgt004_fallback_around_a_wrapper_in_its_caller_fires():
    msgs = _messages(FGT004_CALLER_FALLBACK, "FGT004")
    assert any("calls a kernel's wrapper (`repro_torch.kernels.node_fused"
               ".ops.node_fused`)" in m for m in msgs), msgs
    assert any("calls a kernel's wrapper (`repro_torch.kernels.panel_qr"
               ".panel_qr`)" in m for m in msgs), msgs
    assert len(msgs) == 2, msgs  # the plain version's `try` is not one


def test_fgt004_import_time_build_triton_and_environment_fire():
    path = "src/repro_torch/kernels/thing/kernel.py"
    msgs = _messages(FGT004_IMPORT_TIME, "FGT004", path)
    assert any("`triton` imported at module level" in m for m in msgs)
    assert any("_build.library` runs at module level" in m for m in msgs)
    assert any("os.environ" in m for m in msgs)
    assert len(msgs) == 3, msgs  # nothing inside `launch`
    # the environment rule covers kernels/ and core/ only
    assert not any("os.environ" in m for m in _messages(
        FGT004_IMPORT_TIME, "FGT004", "src/repro_torch/launch/x.py"))


def test_fgt004_toolchain_lookup_is_exempt_by_name():
    src = """
        import os

        def _nvcc():
            return os.environ.get("CUDA_HOME", "/usr/local/cuda")

        def other():
            return os.getenv("CUDA_HOME")
    """
    msgs = _messages(src, "FGT004", "src/repro_torch/kernels/_build.py")
    assert len(msgs) == 1 and "os.getenv" in msgs[0], msgs


# -- FGT005 / FGT006 lock discipline and thread escape -----------------------

FGT005_BAD = """
    from repro_torch.sanitizer.locks import san_lock

    class Server:
        def __init__(self):
            self._lock = san_lock("server")
            self.count = 0
            self.items = []

        def bump(self):
            self.count += 1

        def stats(self):
            return list(self.items)

        def note(self):
            with self._lock:
                self.items.append(1)
"""

FGT005_GOOD = """
    from repro_torch.sanitizer.locks import san_lock

    class Server:
        def __init__(self):
            self._lock = san_lock("server")
            self.count = 0

        def bump(self):
            with self._lock:
                self.count += 1

        def stats(self):
            with self._lock:
                return self.count
"""


def test_fgt005_fgt006_unlocked_write_and_read_fire():
    findings = _findings(FGT005_BAD)
    assert any(f.rule == "FGT005" and "Server.bump writes `self.count`"
               in f.message for f in findings), findings
    assert any(f.rule == "FGT006" and "Server.stats reads" in f.message
               and "self.items" in f.message for f in findings)


def test_fgt005_fgt006_locked_access_quiet_and_scoped_to_the_port():
    assert {f.rule for f in _findings(FGT005_GOOD)} & {"FGT005",
                                                      "FGT006"} == set()
    outside = _findings(FGT005_BAD, "src/repro/core/fixture.py")
    assert {f.rule for f in outside} & {"FGT005", "FGT006"} == set()


# -- FGT007 sanitizer routing ------------------------------------------------

FGT007_BAD = """
    import threading
    from threading import Thread

    def start(worker):
        lock = threading.Lock()
        t = Thread(target=worker, daemon=True)
        return lock, t, threading.Condition
"""

FGT007_GOOD = """
    import threading

    from repro_torch.sanitizer.locks import san_lock
    from repro_torch.sanitizer.threads import san_thread

    def start(worker):
        lock = san_lock("start.lock")
        t = san_thread(worker, daemon=True)
        return lock, t, threading.Event(), threading.local()
"""


def test_fgt007_raw_threading_fires_as_the_sanitizer_scan_does():
    msgs = _messages(FGT007_BAD, "FGT007")
    for raw in ("threading.Thread", "threading.Lock",
                "threading.Condition"):
        assert any(f"`{raw}`" in m for m in msgs), (raw, msgs)


def test_fgt007_wrappers_quiet_and_the_sanitizer_itself_exempt():
    assert _findings(FGT007_GOOD, rule="FGT007") == []
    assert _findings(FGT007_BAD, "src/repro_torch/sanitizer/locks.py",
                     "FGT007") == []


# -- FGT008 import boundaries ------------------------------------------------

FGT008_BAD = """
    import jax.numpy as jnp
    from repro.core import engine
    import torch
"""


def test_fgt008_jax_and_the_jax_package_fire_anywhere_in_the_port():
    msgs = _messages(FGT008_BAD, "FGT008")
    assert any("`jax.numpy`" in m for m in msgs)
    assert any("`repro.core`" in m for m in msgs)
    assert not any("`torch`" in m for m in msgs)


def test_fgt008_planner_and_analysis_boundaries():
    planner = "src/repro_torch/planner/cost.py"
    src = """
        import numpy as np
        import torch
        from repro_torch.core import engine
        from ..core.join_tree import JoinTree
        from .stats import stats_for
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            from repro_torch.core.relation import Database
    """
    msgs = _messages(src, "FGT008", planner)
    assert any("`torch`" in m for m in msgs)
    assert any("`repro_torch.core`" in m for m in msgs)
    assert any("`repro_torch.core.join_tree`" in m for m in msgs)
    assert len(msgs) == 3, msgs
    analysis = "src/repro_torch/analysis/rules/x.py"
    msgs = _messages("""
        import ast
        import numpy
        from ..framework import Rule
        from repro_torch.analysis.callgraph import Program
        from repro_torch.core import engine
    """, "FGT008", analysis)
    assert len(msgs) == 2, msgs
    assert any("`numpy`" in m for m in msgs)
    assert any("`repro_torch.core`" in m for m in msgs)


# -- FGT009 capture sync -----------------------------------------------------

FGT009_BAD = """
    import torch

    def capture(graph, static, n):
        with torch.cuda.graph(graph):
            out = body(static, n)
        return out

    def body(x, n):
        return helper(x * 2, n)

    def helper(y, n):
        if y.sum() > 0:
            y = y + 1
        s = y.max().item()
        torch.cuda.synchronize()
        c = torch.linalg.cholesky(y)
        ok, info = torch.linalg.cholesky_ex(y)
        return y.cpu(), int(y[0]), s, c, n * y.shape[0] + y.numel()
"""

# The same helpers outside any capture: nothing is captured, nothing fires.
FGT009_EAGER = FGT009_BAD.replace(
    "        with torch.cuda.graph(graph):\n            out = body(static, n)",
    "        out = body(static, n)")


def test_fgt009_fires_two_calls_below_a_capture():
    findings = _findings(FGT009_BAD, rule="FGT009")
    ops = {f.message.split("`")[1] for f in findings}
    assert {"a condition", ".item()", "torch.cuda.synchronize()",
            "torch.linalg.cholesky", ".cpu()", "int()"} <= ops, ops
    assert all(f.traced_context == ("body", "helper") for f in findings)
    assert all("captured via body -> helper" in f.message for f in findings)
    assert not any("cholesky_ex" in f.message for f in findings)
    assert len(findings) == 6, [f.message for f in findings]


def test_fgt009_same_code_outside_a_capture_is_quiet():
    assert FGT009_EAGER != FGT009_BAD
    assert _findings(FGT009_EAGER, rule="FGT009") == []


def test_fgt009_static_parameters_and_metadata_are_concrete():
    src = """
        import torch

        class Engine:
            def _capture(self, g, kind, plan, data, options):
                with torch.cuda.graph(g):
                    return self._body(kind, plan, data, options)

            def _body(self, kind, plan, data, options, *, k: int = 0):
                if kind == "qr" and options["use_kernel"] and k > 0:
                    pass
                n = int(data[0].shape[0]) + len(data) + plan.spec.num_cols
                if data[0].dtype == torch.float64 and n > 1:
                    return torch.empty(n, device=data[0].device)
                return data[0] if data[0] is not None else None
    """
    assert _findings(src, rule="FGT009") == []


def test_fgt009_graphed_callables_are_roots():
    src = """
        import torch

        def step(x):
            return x.max().item()

        graphed = torch.cuda.make_graphed_callables(step, (None,))
    """
    msgs = _messages(src, "FGT009")
    assert len(msgs) == 1 and "make_graphed_callables capture" in msgs[0]


# -- FGT010 capture effects --------------------------------------------------

FGT010_BAD = """
    import torch

    CALLS = {"n": 0}
    SEEN = []

    class Engine:
        def capture(self, graph, x):
            with torch.cuda.graph(graph):
                return self._body(x)

        def _body(self, x):
            return self._step(x)

        def _step(self, x):
            return self._inner(x)

        def _inner(self, x):
            CALLS["n"] += 1
            SEEN.append(x.shape)
            self.last = x
            print("captured")
            noise = torch.randn(x.shape, device=x.device)
            return x + noise
"""

FGT010_EAGER = FGT010_BAD.replace(
    "            with torch.cuda.graph(graph):\n"
    "                return self._body(x)",
    "            return self._body(x)")

FGT010_GOOD = """
    import torch

    class Engine:
        def capture(self, graph, x, gen):
            with torch.cuda.graph(graph):
                return self._body(x, gen)

        def _body(self, x, gen):
            return step(x, gen)

    def step(x, gen):
        out = {}
        out["y"] = x * 2
        return out["y"] + torch.randn(x.shape, generator=gen)
"""

# A lock does not make a per-call effect right under a capture.
FGT010_LOCKED = """
    import torch

    from repro_torch.sanitizer.locks import san_lock

    _LOCK = san_lock("calls")
    CALLS = {"n": 0}

    class Engine:
        def __init__(self):
            self._count_lock = san_lock("engine")
            self.calls = 0

        def capture(self, graph, x):
            with torch.cuda.graph(graph):
                return self._body(x)

        def _body(self, x):
            return self._step(x)

        def _step(self, x):
            with self._count_lock:
                self.calls += 1
            with _LOCK:
                CALLS["n"] += 1
            return x * 2
"""

# The memo caches of `_CACHES`, filled once per process under their lock.
FGT010_CACHES = """
    import torch

    from repro_torch.sanitizer.locks import san_lock

    _lock = san_lock("build")
    _libs = {}
    BUILD_LOG = {}
    OTHER = {}

    class Engine:
        def capture(self, graph, x):
            with torch.cuda.graph(graph):
                return self._body(x)

        def _body(self, x):
            return library("thing")

    def library(name):
        with _lock:
            BUILD_LOG[name] = ""
            _libs[name] = object()
            OTHER[name] = 1
        _libs[name] = object()
        return _libs[name]
"""


def test_fgt010_fires_two_calls_below_a_capture():
    msgs = _messages(FGT010_BAD, "FGT010")
    for what in ("mutates global/closure container `CALLS`",
                 "mutates global/closure `SEEN` (.append)",
                 "writes `self.last`", "calls print()",
                 "draws from a global RNG (`torch.randn`"):
        assert any(what in m for m in msgs), (what, msgs)
    assert all("captured via Engine._body -> Engine._step -> Engine._inner"
               in m for m in msgs), msgs
    assert len(msgs) == 5, msgs


def test_fgt010_same_code_outside_a_capture_and_good_code_are_quiet():
    assert _findings(FGT010_EAGER, rule="FGT010") == []
    assert _findings(FGT010_GOOD, rule="FGT010") == []


def test_fgt010_counter_under_a_lock_below_a_capture_fires():
    msgs = _messages(FGT010_LOCKED, "FGT010")
    assert any("writes `self.calls`" in m for m in msgs), msgs
    assert any("mutates global/closure container `CALLS`" in m
               for m in msgs), msgs
    assert all("captured via Engine._body -> Engine._step" in m
               for m in msgs), msgs
    assert len(msgs) == 2, msgs


def test_fgt010_only_the_named_memo_caches_under_their_lock_are_exempt():
    msgs = _messages(FGT010_CACHES, "FGT010",
                     "src/repro_torch/kernels/_build.py")
    # OTHER is not a memo cache; `_libs` written outside the lock is not
    # exempt either.
    assert len(msgs) == 2, msgs
    assert any("container `OTHER`" in m for m in msgs), msgs
    assert any("container `_libs`" in m for m in msgs), msgs
    # The same names in another module are not the port's caches.
    assert len(_messages(FGT010_CACHES, "FGT010")) == 4


# -- FGT011 donation ---------------------------------------------------------

FGT011_BAD = """
    from repro_torch.core.engine import FigaroEngine

    def serve(plan, batch):
        engine = FigaroEngine()
        r = engine.qr(plan, batch, batched=True)
        return r, batch[0].sum()

    def loop(plan, batch):
        engine = FigaroEngine(donate_data=True)
        for _ in range(3):
            engine.svd(plan, batch, batched=True)
"""

FGT011_GOOD = """
    from repro_torch.core.engine import FigaroEngine, default_engine

    def serve(plan, batch):
        engine = FigaroEngine(donate_data=False)
        r = engine.qr(plan, batch, batched=True)
        return r, batch[0].sum()

    def shared(plan, batch):
        engine = default_engine()
        engine.qr(plan, batch)
        return batch

    def fresh(plan, make):
        engine = FigaroEngine()
        for _ in range(3):
            batch = make()
            engine.qr(plan, batch, batched=True)
"""


def test_fgt011_request_list_reread_after_a_donating_dispatch_fires():
    msgs = _messages(FGT011_BAD, "FGT011")
    assert any("`batch` is read at line" in m for m in msgs), msgs
    assert any("inside a loop that never rebinds it" in m for m in msgs)


def test_fgt011_non_donating_and_rebinding_paths_quiet():
    assert _findings(FGT011_GOOD, rule="FGT011") == []


# -- FGT012 slab layout ------------------------------------------------------

FGT012_BAD = """
    import dataclasses

    def layout(nodes):
        acc = 0
        out = []
        for sp in nodes:
            node = dataclasses.replace(sp, tail_row0=acc,
                                       out_row0=acc + sp.m)
            out.append(node)
            acc += sp.m
        return out
"""

FGT012_GOOD = FGT012_BAD.replace("acc += sp.m\n", "acc += sp.m + sp.K\n")


def test_fgt012_stale_row_bump_fires_and_canonical_layout_quiet():
    msgs = _messages(FGT012_BAD, "FGT012")
    assert any("must advance by `<node>.m + <node>.K`" in m for m in msgs)
    assert FGT012_GOOD != FGT012_BAD
    assert _findings(FGT012_GOOD, rule="FGT012") == []


# -- suppressions ------------------------------------------------------------

_SUPPRESSIBLE = [
    ("FGT002", FGT002_BAD, CORE),
    ("FGT003", FGT003_BAD, CORE),
    ("FGT004", FGT004_OPS_BAD, OPS),
    ("FGT005", FGT005_BAD, CORE),
    ("FGT006", FGT005_BAD, CORE),
    ("FGT007", FGT007_BAD, CORE),
    ("FGT008", FGT008_BAD, CORE),
    ("FGT009", FGT009_BAD, CORE),
    ("FGT010", FGT010_BAD, CORE),
    ("FGT011", FGT011_BAD, CORE),
    ("FGT012", FGT012_BAD, CORE),
]


@pytest.mark.parametrize("rule,source,path", _SUPPRESSIBLE,
                         ids=[r for r, _, _ in _SUPPRESSIBLE])
def test_line_suppression_is_honoured(rule, source, path):
    src = textwrap.dedent(source)
    found = [f for f in analyze_source(src, path, all_rules())
             if f.rule == rule]
    assert found, rule
    lines = src.splitlines()
    for line in {f.line for f in found}:
        lines[line - 1] += (f"  # figaro-lint: disable={rule} -- "
                            f"deliberate")
    again = [f for f in analyze_source("\n".join(lines) + "\n", path,
                                       all_rules()) if f.rule == rule]
    assert again == [], [f.render() for f in again]


def test_suppression_of_another_rule_or_in_a_string_is_inert():
    src = textwrap.dedent(FGT003_BAD).replace(
        "y = x.to(torch.float32)",
        "y = x.to(torch.float32)  # figaro-lint: disable=FGT009 -- no")
    assert any("torch.float32" in f.message
               for f in analyze_source(src, CORE, all_rules()))
    src = 'X = "# figaro-lint: disable-file=FGT008"\nimport jax\n'
    assert _findings(src, rule="FGT008")


# -- the real tree, the CLI, the reports -------------------------------------

def test_port_tree_has_no_finding_without_a_baseline():
    findings = analyze_paths([str(PORT)], root=str(REPO))
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_port_capture_root_is_the_engine_body():
    """The port's captures: the engine's R body (its kind and options
    static), the plan-closed closures' body (`figaro_qr_fn`/`figaro_r0_fn`)
    and the LM's decode step (`train/serve.py:DecodeGraph` names
    ``Transformer.decode_step`` through the class, so the call resolves)."""
    program = load_program([str(PORT)], root=str(REPO))
    roots = program.graph.roots
    decode = "repro_torch.models.transformer:Transformer.decode_step"
    closure = "repro_torch.core.engine:_PlanClosure._body"
    assert set(roots) == {"repro_torch.core.engine:FigaroEngine._body",
                          closure, decode}
    assert roots["repro_torch.core.engine:FigaroEngine._body"].static == {
        "kind", "options"}
    assert roots[decode].kind == "cuda.graph"
    assert roots[closure].kind == "cuda.graph"
    captured = program.graph.captured
    for fn in ("repro_torch.core.figaro:_r0_batch",
               "repro_torch.core.postprocess:postprocess_r0",
               "repro_torch.kernels.node_fused.kernel:fused_node_pass",
               "repro_torch.kernels.panel_qr.kernel:panel_qr_wy",
               "repro_torch.models.transformer:Transformer._stack",
               "repro_torch.models.transformer:Transformer._logits"):
        assert fn in captured, fn
    for fn in ("repro_torch.core.engine:FigaroEngine._tail",
               "repro_torch.models.transformer:Transformer.prefill"):
        assert fn not in captured, fn


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args], cwd=cwd,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)


def test_cli_exit_codes_and_reports(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent(FGT003_BAD))
    out = _cli("src/repro_torch/core", cwd=tmp_path)
    assert out.returncode == 1, out.stderr
    assert "src/repro_torch/core/bad.py" in out.stdout
    assert {line.split()[1] for line in out.stdout.splitlines()
            if ": FGT" in line} == {"FGT003"}
    # a baseline written by hand accepts exactly its findings
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"version": 1, "findings": [
        {"rule": "FGT003", "path": "src/repro_torch/core/bad.py",
         "message": line.split(": ", 2)[2], "justification": "fixture"}
        for line in out.stdout.splitlines() if ": FGT003 " in line]}))
    accepted = _cli("--baseline", str(base), "src/repro_torch/core",
                    cwd=tmp_path)
    assert accepted.returncode == 0, accepted.stdout
    assert "baselined finding(s) suppressed" in accepted.stdout
    bad.write_text("X = 1\n")  # fixed: the baseline is stale now
    stale = _cli("--baseline", str(base), "src/repro_torch/core",
                 cwd=tmp_path)
    assert stale.returncode == 1 and "stale baseline" in stale.stdout
    clean = _cli("src/repro_torch")
    assert clean.returncode == 0, clean.stdout
    assert clean.stdout.strip().endswith("figaro-lint: 0 finding(s)")
    graph = _cli("--report", "callgraph", "src/repro_torch")
    assert graph.returncode == 0
    assert ("capture root [cuda.graph]: "
            "repro_torch.core.engine:FigaroEngine._body") in graph.stdout
    unused = _cli("--report", "unused")
    assert unused.returncode == 0
    assert unused.stdout.strip().endswith("0 orphan module(s)")


def test_unused_report_shows_no_orphan_in_the_port():
    report = unused_report(src_root=str(REPO / "src"),
                           external=[str(REPO / "tests"),
                                     str(REPO / "tools"),
                                     str(REPO / "chip_smoke.py")])
    assert report["orphans"] == [], report["orphans"]
    classes = {m: i["class"] for m, i in report["modules"].items()}
    assert classes["repro_torch.core.engine"] == "facade"
    assert classes["repro_torch.analysis.rules.graph_key"] == "entrypoint"
    assert classes["repro_torch.configs.shapes"] == "external-only"


def test_analysis_imports_with_torch_numpy_jax_and_repro_blocked():
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (PORT / "analysis").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for name in ('torch', 'numpy', 'jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {mods!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert "repro_torch.analysis.rules.capture_sync" in mods
