"""Rule framework for the port's figaro-lint: findings, suppressions, the
file runner (a copy of the JAX package's ``analysis/framework.py``: the port
imports nothing of that package).

A rule is a small class with a stable id (``FGT002``...), a default severity,
and a ``check(ctx)`` generator over `Finding`s for one parsed file. The runner
(`analyze_paths`) parses each file once, hands every rule the same
`FileContext` (AST + source + resolved import aliases), and filters the
yielded findings through the file's suppression comments:

    expr  # figaro-lint: disable=FGT009 -- reason
    # figaro-lint: disable-file=FGT003 -- reason

Line suppressions match findings anchored on that physical line; file
suppressions match the whole module. Suppressions should carry a
``--``-separated reason for review, but the analyzer only needs the rule
list.

Everything here is stdlib-only on purpose: the analyzer runs without torch,
numpy or jax installed.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import os
import re
import tokenize
from typing import Iterable, Iterator


class Severity(enum.IntEnum):
    """Ordered so ``max()`` over findings is the run's worst severity."""

    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error" in human output, not "Severity.ERROR"
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str         # "FGT002"
    severity: Severity
    path: str         # repo-relative, posix separators
    line: int         # 1-based
    message: str
    fix_hint: str = ""
    #: For interprocedural findings: the short-name call chain from a capture
    #: root (a call inside ``torch.cuda.graph``, a graphed callable) to the
    #: finding site.
    traced_context: tuple[str, ...] = ()

    def fingerprint(self) -> tuple[str, str, str]:
        """Baseline identity: line numbers drift with unrelated edits, so the
        baseline matches on (rule, path, message) instead."""
        return (self.rule, self.path, self.message)

    def to_json(self) -> dict:
        """The ``--json`` form, with the JAX package's keys."""
        return {"rule": self.rule, "severity": str(self.severity),
                "path": self.path, "line": self.line,
                "message": self.message, "fix_hint": self.fix_hint,
                "traced_context": list(self.traced_context)}

    def render(self) -> str:
        """Human-readable form, fix hint included on its own indented line —
        the hint must reach terminal users, not just the `--json` payload."""
        head = (f"{self.path}:{self.line}: {self.rule} {self.severity}: "
                f"{self.message}")
        if not self.fix_hint:
            return head
        return f"{head}\n    fix: {self.fix_hint}"


_SUPPRESS_RE = re.compile(
    r"#\s*figaro-lint:\s*(disable|disable-file)\s*=\s*"
    r"(?P<rules>[A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)")


@dataclasses.dataclass
class Suppressions:
    by_line: dict[int, set[str]]  # physical line -> suppressed rule ids
    file_wide: set[str]

    def covers(self, finding: Finding) -> bool:
        if finding.rule in self.file_wide:
            return True
        return finding.rule in self.by_line.get(finding.line, ())


def _parse_suppressions(source: str) -> Suppressions:
    """Comment scan via tokenize, so a suppression-looking *string literal*
    in fixture code never suppresses anything."""
    by_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    lines = source.splitlines(keepends=True)
    try:
        tokens = tokenize.generate_tokens(iter(lines).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            if m.group(1) == "disable-file":
                file_wide |= rules
            else:
                by_line.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenizeError:
        pass  # unparsable files already surface as FGT000
    return Suppressions(by_line, file_wide)


class FileContext:
    """Everything a rule sees for one file: AST, source, import aliases."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path          # repo-relative posix path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        #: local alias -> dotted module/symbol it names, e.g.
        #: {"F": "torch.nn.functional", "dist": "torch.distributed"}
        self.aliases = _collect_aliases(tree)

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted name of a Name/Attribute chain with the leading alias
        expanded: ``F.relu`` -> "torch.nn.functional.relu". None for anything
        that is not a plain dotted chain."""
        parts = _dotted_parts(node)
        if parts is None:
            return None
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])


def _dotted_parts(node: ast.AST) -> list[str] | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def port_path(path: str) -> str | None:
    """The part of a path below ``repro_torch/`` (``core/engine.py``), or
    None outside the port: every rule of this package is scoped to it."""
    path = path.replace("\\", "/")
    at = path.find("repro_torch/")
    if at < 0 or (at and path[at - 1] != "/"):
        return None
    return path[at + len("repro_torch/"):]


class Rule:
    """Base class: subclasses set the id/severity/hint and implement check.

    Interprocedural rules additionally implement ``check_program``, which the
    runner calls once per run with the whole-program `Program` (call graph +
    dataflow over every analyzed file). During a run every rule also sees the
    program on ``self.program`` — per-file rules can use it for call-graph
    queries (FGT006's cross-file exemption) while staying file-anchored.
    """

    rule_id: str = "FGT000"
    severity: Severity = Severity.ERROR
    fix_hint: str = ""
    #: Whole-program view, set by the runner for the duration of a run.
    program = None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def check_program(self, program) -> Iterator[Finding]:
        """Whole-program pass; called once per run, after the per-file
        passes. Default: no interprocedural findings."""
        return iter(())

    def finding(self, ctx: FileContext, node: ast.AST | int, message: str,
                *, severity: Severity | None = None,
                fix_hint: str | None = None,
                traced_context: tuple[str, ...] = ()) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule=self.rule_id,
                       severity=self.severity if severity is None else severity,
                       path=ctx.path, line=line, message=message,
                       fix_hint=self.fix_hint if fix_hint is None else fix_hint,
                       traced_context=tuple(traced_context))


def _iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", ".git"))
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def _relpath(path: str, root: str | None) -> str:
    rel = os.path.relpath(path, root) if root else path
    if rel.startswith(".." + os.sep):  # outside the root: keep it absolute
        rel = os.path.abspath(path)
    return rel.replace(os.sep, "/")


def _syntax_error_finding(path: str, e: SyntaxError) -> Finding:
    return Finding(
        rule="FGT000", severity=Severity.ERROR, path=path,
        line=e.lineno or 1,
        message=(f"syntax error: {e.msg} — figaro-lint cannot analyze "
                 f"this file (suppressions use `# figaro-lint: "
                 f"disable=FGTxxx -- reason` once it parses)"),
        fix_hint=("fix the parse error first; FGT000 itself cannot be "
                  "suppressed because suppression comments are read "
                  "from the parsed file"))


def _run_rules(items: list[tuple[FileContext, Suppressions]],
               rules: list[Rule]) -> list[Finding]:
    """Shared runner: per-file passes over every context, then one
    whole-program pass per rule — all against a single `Program` built from
    the full context set, so `analyze_source` (one-file program) and
    `analyze_paths` (whole-tree program) share semantics."""
    from .callgraph import Program  # deferred: callgraph imports framework

    program = Program([ctx for ctx, _ in items])
    sups = {ctx.path: sup for ctx, sup in items}
    out: list[Finding] = []
    seen: set[tuple[str, str, int, str]] = set()

    def add(finding: Finding) -> None:
        # Dedupe: rules that walk nested scopes can surface one defect
        # from two enclosing scopes.
        key = (finding.rule, finding.path, finding.line, finding.message)
        if key in seen:
            return
        sup = sups.get(finding.path)
        if sup is not None and sup.covers(finding):
            return
        seen.add(key)
        out.append(finding)

    try:
        for rule in rules:
            rule.program = program
        for rule in rules:
            for ctx, _ in items:
                for finding in rule.check(ctx):
                    add(finding)
            for finding in rule.check_program(program):
                add(finding)
    finally:
        for rule in rules:
            rule.program = None
    return out


def analyze_source(source: str, path: str,
                   rules: Iterable[Rule]) -> list[Finding]:
    """Analyze one in-memory module (the fixture-test entry point). The
    module becomes a single-file `Program`, so interprocedural rules run on
    fixtures too — with the call graph restricted to what the file defines."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [_syntax_error_finding(path, e)]
    ctx = FileContext(path, source, tree)
    sup = _parse_suppressions(source)
    return _run_rules([(ctx, sup)], list(rules))


def analyze_paths(paths: Iterable[str], *, rules: Iterable[Rule] | None = None,
                  root: str | None = None) -> list[Finding]:
    """Run every rule over every ``.py`` file under ``paths``.

    ``root`` (default cwd) anchors the repo-relative paths findings carry —
    the baseline and suppression story depends on paths being stable across
    checkouts.
    """
    if rules is None:
        from .rules import all_rules
        rules = all_rules()
    rules = list(rules)
    root = os.getcwd() if root is None else root
    findings: list[Finding] = []
    items: list[tuple[FileContext, Suppressions]] = []
    for fpath in _iter_py_files(paths):
        rel = _relpath(fpath, root)
        try:
            with open(fpath, encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(
                rule="FGT000", severity=Severity.ERROR,
                path=rel, line=1,
                message=f"unreadable file: {e}",
                fix_hint="fix the file's encoding/permissions or remove it "
                         "from the analyzed paths"))
            continue
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            findings.append(_syntax_error_finding(rel, e))
            continue
        items.append((FileContext(rel, source, tree),
                      _parse_suppressions(source)))
    findings.extend(_run_rules(items, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def load_program(paths: Iterable[str], *, root: str | None = None):
    """Build the whole-program view (`callgraph.Program`) for ``paths``
    without running any rules — the `--report callgraph` entry point.
    Unreadable/unparsable files are skipped (they surface as FGT000 in the
    lint run, not here)."""
    from .callgraph import Program

    root = os.getcwd() if root is None else root
    contexts: list[FileContext] = []
    for fpath in _iter_py_files(paths):
        rel = _relpath(fpath, root)
        try:
            with open(fpath, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (OSError, UnicodeDecodeError, SyntaxError):
            continue
        contexts.append(FileContext(rel, source, tree))
    return Program(contexts)
