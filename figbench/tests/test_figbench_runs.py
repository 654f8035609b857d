"""The manifest's rules, whole runs of every cell on the CPU at a tiny size
(sound, with faults planted in the port, and the float64 cell's control),
the import boundary, a cell added from new files alone, and the refusal to
run without a card. The runs go in processes of their own, so that no
test's imports reach them."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from figbench.manifest import Manifest, problems  # noqa: E402

MANIFEST = Manifest()
SCENARIOS = ROOT / "figbench" / "tests" / "_figbench_scenarios.py"


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
                MKL_NUM_THREADS="2")


def _lines(proc) -> list:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def test_manifest_keeps_the_rules():
    assert problems(MANIFEST) == []
    data = MANIFEST.data
    assert {c["name"] for c in data["configs"]} == {"favorita"}
    assert [w["name"] for w in data["workloads"]] == [
        "favorita.serve_qr", "favorita.qr", "favorita.fit_f64"]
    assert all(w["chips"] == 1 for w in data["workloads"])
    assert [m["name"] for m in data["end_to_end"]] == [
        "setup_s", "requests_per_s", "latency_p95_ms"]
    assert len(data["per_layer"]) == 9
    # the served tail is per layer there; end to end in the direct cells
    assert [m["name"] for m in MANIFEST.metrics("favorita.serve_qr", False)] \
        == ["setup_s", "requests_per_s"]
    for cell in ("favorita.qr", "favorita.fit_f64"):
        assert [m["name"] for m in MANIFEST.metrics(cell, False)] == [
            "setup_s", "requests_per_s", "latency_p95_ms"]
    assert "serve.latency_p95_ms" in [
        m["name"] for m in MANIFEST.metrics("favorita.serve_qr", True)]
    bad = Manifest()
    bad.data["end_to_end"][-1]["workloads"] = ["favorita.nowhere"]
    assert problems(bad) == [
        "latency_p95_ms: unknown cell 'favorita.nowhere'"]
    bounds = {m["name"]: m["bound"] for m in data["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert (2 + 14 * 24) * (data["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    cfg = MANIFEST.config("favorita")
    assert cfg["session"] == {"use_kernel": True, "assembly": "band"}
    assert all(p["workloads"] for p in data["per_layer"])


def test_every_cell_runs_and_each_fault_is_caught():
    cases = ["favorita.serve_qr:sound", "favorita.qr:sound",
             "favorita.fit_f64:sound", "favorita.serve_qr:answer",
             "favorita.serve_qr:half", "favorita.qr:answer",
             "favorita.fit_f64:answer", "favorita.fit_f64:control"]
    proc = subprocess.run([sys.executable, str(SCENARIOS), *cases],
                          capture_output=True, text=True, timeout=600,
                          env=_env(), cwd=ROOT)
    lines = _lines(proc)
    got = {line["scenario"]: line for line in lines if "scenario" in line}
    assert set(got) == set(cases)
    for case, line in got.items():
        assert line["attempted"] > 0
        assert line["correct"] == case.endswith(":sound"), (case, line)
    assert lines[-1] == {"forbidden": []}


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "figbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(repro_torch|repro|jax)\b",
                             text, re.M), path
    code = ("import sys; import figbench.reference.join, "
            "figbench.reference.checks; print(sorted({m.split('.')[0] for m "
            "in sys.modules} & {'repro_torch', 'repro', 'jax', 'jaxlib'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=_env())
    assert proc.stdout.strip() == "[]", proc.stderr[-2000:]


def test_a_cell_config_traffic_and_metric_from_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "figbench", tmp_path / "figbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = dict(MANIFEST.data)
    bench = tmp_path / "figbench"
    cfg = dict(MANIFEST.config("favorita"), name="shop", sales_rows=500,
               stores=3, items=7, days=9)
    (bench / "configs" / "shop.json").write_text(json.dumps(cfg))
    (bench / "workloads" / "qr_twice.json").write_text(json.dumps(
        {"driver": "direct", "calls": [{"kind": "qr"}, {"kind": "qr"}],
         "dtype": "float64", "why": "two qr calls in turn"}))
    (bench / "limits" / "shop.qr_twice.json").write_text(
        json.dumps({"r_gram": 1e-9}))
    (bench / "metrics" / "answers.per_s.py").write_text(
        "def read(rec):\n    return rec.requests / rec.seconds\n")
    data["configs"] = data["configs"] + [
        {"name": "shop", "source": "a test", "file": "figbench/configs/shop.json",
         "reduced": [], "why": "a test"}]
    data["workloads"] = data["workloads"] + [
        {"name": "shop.qr_twice", "config": "shop", "traffic": "qr_twice",
         "chips": 1, "why": "a test"}]
    data["per_layer"] = data["per_layer"] + [
        {"name": "answers.per_s", "unit": "requests/s", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "requests_per_s",
         "workloads": ["shop.qr_twice"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    assert problems(Manifest(tmp_path)) == []
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            "from figbench.harness import run_cell\n"
            "from figbench.manifest import Manifest\n"
            f"out = run_cell('shop.qr_twice', 3, 0.5, True, device='cpu', "
            f"manifest=Manifest({str(tmp_path)!r}), log=lambda *a: None)\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path, env=_env())
    out = _lines(proc)[-1]
    assert out["correct"], out
    assert out["metrics"]["answers.per_s"]["value"] > 0
    assert set(out["checks"]) == {"failed", "r_gram"}


def test_without_a_card_the_run_refuses_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "figbench/run.py", "--workload", "favorita.qr",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(_env(), CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
    assert "needs 1 CUDA card" in proc.stderr


@pytest.mark.parametrize("cell", ["favorita.serve_qr", "favorita.qr",
                                  "favorita.fit_f64"])
def test_the_reference_control_fails_every_cell(cell):
    from figbench.control import reference_control

    sys.path.insert(0, str(SCENARIOS.parent))
    from _figbench_scenarios import tiny_config

    for seed in (1, 2, 3):
        out = reference_control(MANIFEST, cell, seed,
                                config=tiny_config(MANIFEST, cell))
        assert out["correct"] is False, out
