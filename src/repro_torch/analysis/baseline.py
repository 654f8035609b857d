"""Baseline handling: a list of accepted (justified) findings (a copy of
the JAX package's ``analysis/baseline.py``). The port's tree runs with no
baseline: ``python -m repro_torch.analysis src/repro_torch`` must report
nothing.

With ``--baseline FILE`` the run is differential: the file records every
accepted finding, each with a justification, and the run fails on any
finding NOT in it. A deliberate violation carries an in-source suppression
comment instead wherever it can (the reason lives next to the code).

Matching is by fingerprint (rule, path, message) — line numbers drift with
unrelated edits and would churn the file. The file is
``{"version": 1, "findings": [{"rule", "path", "message",
"justification"}, ...]}``. ``--write-baseline`` regenerates it from the
current tree, carrying forward the justifications of entries that still
match; a new entry gets a TODO marker, so that no accepted finding passes
review without its reason.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from .framework import Finding

BASELINE_VERSION = 1
#: The justification a newly accepted finding gets from `write_baseline`.
TODO_JUSTIFICATION = "TODO: justify or fix"


@dataclasses.dataclass
class Baseline:
    entries: dict[tuple[str, str, str], str]  # fingerprint -> justification

    def covers(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.entries

    def split(self, findings: Iterable[Finding]
              ) -> tuple[list[Finding], list[Finding]]:
        """(new, baselined) partition of ``findings``."""
        new, old = [], []
        for f in findings:
            (old if self.covers(f) else new).append(f)
        return new, old

    def stale(self, findings: Iterable[Finding]) -> list[tuple[str, str, str]]:
        """Baseline entries no longer matched by any finding — fixed
        violations whose entries should be deleted (the baseline must stay
        exact, or it can mask a regression with the same message)."""
        live = {f.fingerprint() for f in findings}
        return sorted(fp for fp in self.entries if fp not in live)

    def to_json(self) -> dict:
        return {
            "version": BASELINE_VERSION,
            "findings": [
                {"rule": rule, "path": path, "message": message,
                 "justification": just}
                for (rule, path, message), just in sorted(self.entries.items())
            ],
        }


def empty_baseline() -> Baseline:
    return Baseline(entries={})


def load_baseline(path: str) -> Baseline:
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    if raw.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{raw.get('version')!r} (expected "
                         f"{BASELINE_VERSION})")
    entries = {}
    for e in raw.get("findings", []):
        entries[(e["rule"], e["path"], e["message"])] = \
            e.get("justification", "")
    return Baseline(entries=entries)


def write_baseline(path: str, findings: Iterable[Finding],
                   previous: Baseline | None = None) -> Baseline:
    """Regenerate the baseline from the current findings, carrying forward
    justifications that still apply; new entries get a TODO marker so review
    can spot unjustified acceptances."""
    prev = previous.entries if previous is not None else {}
    entries = {}
    for f in findings:
        fp = f.fingerprint()
        entries[fp] = prev.get(fp, TODO_JUSTIFICATION)
    baseline = Baseline(entries=entries)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(baseline.to_json(), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return baseline
