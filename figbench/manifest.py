"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its entry in ``configs``;
- a traffic mix: ``workloads/<traffic>.json`` beside this module;
- the limits of a cell's compared numbers: ``limits/<cell>.json``;
- a metric's reader: ``metrics/<metric>.py``, a module with ``read(rec)``
  that returns the metric's value, or None where it finds nothing to read;
- a traffic driver: ``drivers/<driver>.py``, a module with a ``Driver``.

Adding a cell, a configuration, a traffic mix or a metric therefore adds
files and entries and edits none. `problems` lists where the manifest breaks
the rules a benchmark's manifest keeps.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

__all__ = ["Manifest", "problems"]

HERE = pathlib.Path(__file__).resolve().parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
_SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _load_module(path: pathlib.Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"figbench_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    def __init__(self, root: pathlib.Path | None = None):
        self.root = pathlib.Path(root) if root else HERE.parent
        self.bench = self.root / HERE.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        known = sorted(e["name"] for e in self.data[key])
        raise KeyError(f"no {key} entry {name!r}; have {known}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "workloads" / f"{name}.json")
                          .read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json")
                          .read_text())

    def metrics(self, cell: str, traced: bool) -> list:
        """The metrics a run of ``cell`` reports: the end-to-end ones that
        list the cell or list no cells, or with ``traced`` the per-layer
        ones that list the cell."""
        if not traced:
            return [m for m in self.data["end_to_end"]
                    if cell in m.get("workloads", (cell,))]
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        return _load_module(self.bench / "metrics" / f"{metric}.py",
                            metric.replace(".", "_")).read

    def driver(self, name: str):
        return _load_module(self.bench / "drivers" / f"{name}.py",
                            f"driver_{name}").Driver


def problems(m: Manifest) -> list:
    """Where the manifest and its files break the benchmark's rules."""
    out = []
    data = m.data
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in data[key]]
    for n in names:
        if not _NAME.match(n):
            out.append(f"bad name {n!r}")
    for key in ("configs", "workloads"):
        seen = [e["name"] for e in data[key]]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate {key} names")
    metric_names = [e["name"] for key in ("end_to_end", "per_layer")
                    for e in data[key]]
    if len(metric_names) != len(set(metric_names)):
        out.append("duplicate metric names")
    configs = {e["name"] for e in data["configs"]}
    pairs = set()
    for w in data["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"{w['name']}: config and traffic used twice")
        pairs.add((w["config"], w["traffic"]))
        if not _NAME.match(w["traffic"]):
            out.append(f"bad traffic name {w['traffic']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        for f in (m.bench / "limits" / f"{w['name']}.json",
                  m.bench / "workloads" / f"{w['traffic']}.json"):
            if not f.is_file():
                out.append(f"{w['name']}: missing {f.name}")
        if f.is_file():
            traffic = m.traffic(w["traffic"])
            if not (m.bench / "drivers" / f"{traffic['driver']}.py").is_file():
                out.append(f"{w['name']}: missing driver {traffic['driver']}")
    used = {w["config"] for w in data["workloads"]}
    for c in data["configs"]:
        if c["name"] not in used:
            out.append(f"config {c['name']} has no cell")
        if not (m.root / c["file"]).is_file():
            out.append(f"config {c['name']}: missing {c['file']}")
        for k in c["reduced"]:
            if not _NAME.match(k):
                out.append(f"bad reduced key {k!r}")
    e2e_names = {e["name"] for e in data["end_to_end"]}
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    for e in data["end_to_end"] + data["per_layer"]:
        if not _UNIT.match(e["unit"]):
            out.append(f"{e['name']}: bad unit {e['unit']!r}")
        if e["better"] not in ("lower", "higher"):
            out.append(f"{e['name']}: bad better {e['better']!r}")
        if e["source"] not in _SOURCES:
            out.append(f"{e['name']}: bad source {e['source']!r}")
        if not (m.bench / "metrics" / f"{e['name']}.py").is_file():
            out.append(f"{e['name']}: no reader")
    cells = {w["name"] for w in data["workloads"]}
    for e in data["end_to_end"]:
        for c in e.get("workloads", sorted(cells)):
            if c not in cells:
                out.append(f"{e['name']}: unknown cell {c!r}")
        if e["source"] not in ("host_clock", "device_trace"):
            out.append(f"{e['name']}: end-to-end source {e['source']}")
        if not 0.01 <= e["bound"] <= 0.25:
            out.append(f"{e['name']}: bound {e['bound']}")
    for w in data["workloads"]:
        e2e = [e["name"] for e in m.metrics(w["name"], traced=False)]
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end "
                       "metric")
        layer = m.metrics(w["name"], traced=True)
        if not layer:
            out.append(f"{w['name']}: no per-layer metric")
        for p in layer:
            if p["moves"] not in e2e:
                out.append(f"{p['name']} moves {p['moves']}, which "
                           f"{w['name']} does not report")
    for p in data["per_layer"]:
        if p["moves"] not in e2e_names:
            out.append(f"{p['name']}: moves unknown {p['moves']!r}")
        if not p.get("workloads"):
            out.append(f"{p['name']}: no workloads")
        for c in p.get("workloads", []):
            if c not in cells:
                out.append(f"{p['name']}: unknown cell {c!r}")
    for p in data["per_layer"]:
        if "\n" in p["layer"] or not 1 <= len(p["layer"]) <= 200:
            out.append(f"{p['name']}: bad layer")
    for text in [w["why"] for w in data["workloads"]] + [
            c["why"] for c in data["configs"]] + [
            c["source"] for c in data["configs"]]:
        if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            out.append(f"bad text {text[:40]!r}")
    return out
