"""The port's figaro-lint command line beyond its findings text: ``--json``
(the JAX package's keys), ``--write-baseline`` (justifications carried
forward, new entries marked, fixed violations stale), ``--warn-only``,
``--root``, ``--dot`` and the JSON reports, run in-process through
`repro_torch.analysis.cli.main`."""

import json
import pathlib

from repro.analysis.framework import Finding as JaxFinding
from repro.analysis.framework import Severity as JaxSeverity
from repro_torch.analysis.baseline import TODO_JUSTIFICATION
from repro_torch.analysis.cli import main

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
ENGINE = "repro_torch.core.engine"
ROOTS = (f"{ENGINE}:FigaroEngine._body", f"{ENGINE}:_PlanClosure._body")


def _run(capsys, *argv):
    rc = main([str(a) for a in argv])
    return rc, capsys.readouterr().out


def _broken_copy(tmp_path, *violations):
    """A copy of the port's ``core/qr.py`` under ``tmp_path`` with one
    function per violation appended: ``x.to(<dtype>)``, an FGT003 each."""
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True, exist_ok=True)
    text = (PORT / "core" / "qr.py").read_text()
    for i, dtype in enumerate(violations):
        text += f"\n\ndef _narrow{i}(x):\n    return x.to(torch.{dtype})\n"
    (core / "qr.py").write_text(text)
    return core


def test_json_of_the_port_tree_has_no_finding(capsys):
    rc, out = _run(capsys, "--json", "--root", REPO, PORT)
    assert rc == 0
    assert json.loads(out) == {"findings": [], "baselined": 0,
                               "stale_baseline": []}


def test_finding_json_has_the_jax_keys(tmp_path, capsys):
    core = _broken_copy(tmp_path, "float32")
    rc, out = _run(capsys, "--json", "--root", tmp_path, core)
    assert rc == 1
    (finding,) = json.loads(out)["findings"]
    want = JaxFinding(rule="FIG003", severity=JaxSeverity.ERROR, path="p",
                      line=1, message="m").to_json()
    assert set(finding) == set(want)
    assert finding["rule"] == "FGT003" and finding["severity"] == "error"
    assert finding["path"] == "src/repro_torch/core/qr.py"
    assert "torch.float32" in finding["message"]


def test_write_baseline_round_trip(tmp_path, capsys):
    core = _broken_copy(tmp_path, "float32")
    base = tmp_path / "baseline.json"
    rc, out = _run(capsys, "--root", tmp_path, "--write-baseline", base, core)
    assert rc == 0 and "wrote 1 finding(s)" in out
    raw = json.loads(base.read_text())
    assert raw["version"] == 1
    (entry,) = raw["findings"]
    assert entry["justification"] == TODO_JUSTIFICATION
    entry["justification"] = "a fixture's deliberate narrowing"
    base.write_text(json.dumps(raw))
    _broken_copy(tmp_path, "float32", "half")  # a second violation
    rc, _ = _run(capsys, "--root", tmp_path, "--baseline", base,
                 "--write-baseline", base, core)
    assert rc == 0
    kept = {e["message"]: e["justification"]
            for e in json.loads(base.read_text())["findings"]}
    assert len(kept) == 2
    assert kept[entry["message"]] == "a fixture's deliberate narrowing"
    (new,) = (m for m in kept if m != entry["message"])
    assert "torch.half" in new and kept[new] == TODO_JUSTIFICATION
    rc, out = _run(capsys, "--json", "--root", tmp_path, "--baseline", base,
                   core)
    assert rc == 0 and json.loads(out)["baselined"] == 2
    (core / "qr.py").write_text((PORT / "core" / "qr.py").read_text())
    rc, out = _run(capsys, "--json", "--root", tmp_path, "--baseline", base,
                   core)
    assert rc == 1
    report = json.loads(out)
    assert report["findings"] == [] and report["baselined"] == 0
    assert sorted(m for _, _, m in report["stale_baseline"]) == sorted(kept)


def test_warn_only_exits_zero_with_findings(tmp_path, capsys):
    core = _broken_copy(tmp_path, "float32")
    rc, out = _run(capsys, "--warn-only", "--root", tmp_path, core)
    assert rc == 0
    assert "FGT003" in out and out.strip().endswith("1 finding(s)")


def test_dot_marks_the_capture_roots(tmp_path, capsys):
    dot = tmp_path / "g.dot"
    rc, out = _run(capsys, "--report", "callgraph", "--dot", dot, "--root",
                   REPO, PORT)
    assert rc == 0 and f"-- DOT graph written to {dot}" in out
    text = dot.read_text()
    assert text.startswith("digraph figaro_flow {")
    assert text.rstrip().endswith("}")
    for root in ROOTS:
        assert f'"{root}" [style=filled, fillcolor="#d95f02"];' in text
    assert (f'"{ENGINE}:FigaroEngine._body" -> '
            f'"repro_torch.core.figaro:_r0_batch";') in text


def test_reports_as_json(capsys, monkeypatch):
    rc, out = _run(capsys, "--report", "callgraph", "--json", "--root", REPO,
                   PORT)
    assert rc == 0
    graph = json.loads(out)
    assert set(ROOTS) <= set(graph["roots"])
    body = graph["functions"]["repro_torch.core.figaro:_r0_batch"]
    assert body["captured"] and body["root"] is None
    assert body["chain"][0] in ROOTS and body["chain"][-1].endswith(
        ":_r0_batch")
    assert graph["functions"][ROOTS[1]]["root"] == "cuda.graph"
    monkeypatch.chdir(REPO)
    rc, out = _run(capsys, "--report", "unused", "--json", "--src-root",
                   REPO / "src")
    assert rc == 0
    unused = json.loads(out)
    assert unused["orphans"] == []
    assert unused["modules"]["repro_torch.core.engine"]["class"] == "facade"
