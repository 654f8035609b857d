"""`--report unused`: the port's import graph and dead-module report.

Builds a static import graph over every module under ``src/repro_torch``
and classifies each module by how it is reached:

  * **facade** — reachable from the public facade ``repro_torch.figaro``
    (what ``import repro_torch.figaro`` pulls in, statically);
  * **entrypoint** — not behind the facade but named by an entry-point root
    (``repro_torch.analysis``) or reachable from one;
  * **external-only** — unreachable from any root, but referenced by
    ``tests/``, ``tools/`` or ``chip_smoke.py``, or imported by a module
    that is (the registry ``repro_torch.configs`` loads its config
    modules);
  * **orphan** — unreachable AND unreferenced: dead code, safe to delete.

Resolution handles the three import forms the tree uses — absolute
(``import repro_torch.core.engine``), from-imports of modules or symbols
(``from repro_torch.core import engine`` / ``from .engine import
FigaroEngine``), and the dynamic registry idiom
``importlib.import_module(f"repro_torch.configs.{name}")``, which is modeled
as an edge to *every* module under the f-string's literal prefix (the
registry can name any of them at runtime).

External references are textual on purpose: a script names a module in an
importlib string or a ``python -m`` line, which no import statement
mentions. A regex over ``repro_torch.dotted.names`` in the external files
catches those. (A copy of the JAX package's ``analysis/imports.py``,
retargeted at the port.)
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator

PACKAGE = "repro_torch"

#: Graph roots: the public facade first, then the executable entry points
#: that users invoke directly with `python -m` (which runs __main__).
DEFAULT_ROOTS = ("repro_torch.figaro", "repro_torch.analysis.__main__")

#: Where external references live: directories and single files.
DEFAULT_EXTERNAL = ("tests", "tools", "chip_smoke.py")

_EXTERNAL_REF_RE = re.compile(
    r"\brepro_torch(?:\.[A-Za-z_][A-Za-z_0-9]*)+")


def _module_name(py_path: str, src_root: str) -> str | None:
    rel = os.path.relpath(py_path, src_root)
    if rel.startswith(".."):
        return None
    parts = rel.replace(os.sep, "/").split("/")
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3]  # strip .py
    return ".".join(parts) if parts else None


def _walk_py(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _fstring_prefix(node: ast.JoinedStr) -> str | None:
    """Literal prefix of an f-string up to the first interpolation."""
    if not node.values:
        return None
    first = node.values[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return None


@dataclasses.dataclass
class ImportGraph:
    """Static module-level import graph for one package tree."""

    src_root: str                       # e.g. "src"
    modules: dict[str, str]             # module name -> file path
    edges: dict[str, set[str]]          # module -> imported modules (in-tree)
    packages: set[str]                  # names that are packages (dirs)

    @classmethod
    def build(cls, src_root: str, package: str = PACKAGE) -> "ImportGraph":
        pkg_dir = os.path.join(src_root, package)
        modules: dict[str, str] = {}
        packages: set[str] = {package}
        for path in _walk_py(pkg_dir):
            name = _module_name(path, src_root)
            if name is None:
                continue
            modules[name] = path
            if path.endswith("__init__.py"):
                packages.add(name)
        graph = cls(src_root=src_root, modules=modules, edges={},
                    packages=packages)
        for name, path in modules.items():
            graph.edges[name] = graph._module_edges(name, path)
        return graph

    # -- edge extraction -----------------------------------------------------

    def _module_edges(self, name: str, path: str) -> set[str]:
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            return set()
        out: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out |= self._resolve_target(a.name)
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(name, node)
                if base is None:
                    continue
                out |= self._resolve_target(base)
                for a in node.names:
                    if a.name != "*":
                        # `from pkg import sub` may name a submodule.
                        out |= self._resolve_target(f"{base}.{a.name}")
            elif isinstance(node, ast.Call):
                out |= self._dynamic_edges(node)
        out.discard(name)
        return out

    def _from_base(self, name: str, node: ast.ImportFrom) -> str | None:
        if not node.level:
            return node.module
        # Relative import: climb from the importer's package.
        base_parts = name.split(".")
        if name not in self.packages:
            base_parts = base_parts[:-1]  # module -> containing package
        climb = node.level - 1
        if climb > len(base_parts):
            return None
        base_parts = base_parts[:len(base_parts) - climb]
        if node.module:
            base_parts = base_parts + node.module.split(".")
        return ".".join(base_parts) if base_parts else None

    def _resolve_target(self, dotted: str) -> set[str]:
        """In-tree modules a dotted import target refers to. Importing a
        package also executes its __init__, so parent packages join too."""
        out: set[str] = set()
        parts = dotted.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            if prefix in self.modules:
                out.add(prefix)
        return out

    def _dynamic_edges(self, node: ast.Call) -> set[str]:
        """`importlib.import_module(f"repro_torch.configs.{...}")` → edges to
        every module under the literal prefix."""
        fn = node.func
        callee = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if callee != "import_module" or not node.args:
            return set()
        arg = node.args[0]
        prefix: str | None = None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return self._resolve_target(arg.value)
        if isinstance(arg, ast.JoinedStr):
            prefix = _fstring_prefix(arg)
        if not prefix or not prefix.startswith(PACKAGE):
            return set()
        prefix = prefix.rstrip(".")
        return {m for m in self.modules
                if m == prefix or m.startswith(prefix + ".")}

    # -- reachability --------------------------------------------------------

    def reachable_from(self, roots: Iterable[str]) -> set[str]:
        seen: set[str] = set()
        stack = [r for r in roots if r in self.modules]
        while stack:
            mod = stack.pop()
            if mod in seen:
                continue
            seen.add(mod)
            # Importing a.b.c first imports packages a and a.b.
            parts = mod.split(".")
            for i in range(1, len(parts)):
                parent = ".".join(parts[:i])
                if parent in self.modules and parent not in seen:
                    stack.append(parent)
            stack.extend(self.edges.get(mod, ()) - seen)
        return seen


def _import_refs(text: str, path: str) -> set[str]:
    """Dotted port names an external file's *import statements* mention —
    catches `from repro_torch.kernels.flash_attn import ref`, where the
    submodule name never appears as a dotted string the regex could see."""
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError:
        return set()
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names
                    if a.name != "*"}
    return {n for n in out if n == PACKAGE or n.startswith(PACKAGE + ".")}


def _external_files(external: Iterable[str]) -> Iterator[str]:
    for entry in external:
        if os.path.isdir(entry):
            yield from _walk_py(entry)
        elif os.path.isfile(entry) and entry.endswith(".py"):
            yield entry


def _external_refs(external: Iterable[str],
                   modules: Iterable[str]) -> dict[str, list[str]]:
    """module -> files outside src/ that mention it. Two detectors: import
    statements (AST), and a dotted-name regex over the raw text (catches
    importlib strings and `python -m repro_torch.analysis` lines that no
    import statement names)."""
    names = set(modules)
    hits: dict[str, set[str]] = {m: set() for m in names}
    for path in _external_files(external):
        try:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
        except (OSError, UnicodeDecodeError):
            continue
        found = set(_EXTERNAL_REF_RE.findall(text))
        found |= _import_refs(text, path)
        for ref in found:
            # "repro_torch.core.engine" also vouches for repro_torch.core.
            parts = ref.split(".")
            for i in range(2, len(parts) + 1):
                cand = ".".join(parts[:i])
                if cand in names:
                    hits[cand].add(path)
    return {m: sorted(files) for m, files in hits.items() if files}


def unused_report(src_root: str = "src",
                  external: Iterable[str] = DEFAULT_EXTERNAL,
                  roots: Iterable[str] = DEFAULT_ROOTS) -> dict:
    """Classify every port module: facade / entrypoint / external-only /
    orphan. ``external`` names directories and files (relative to the
    working directory) whose references keep a module alive. Returns a
    JSON-ready dict; the CLI renders it."""
    graph = ImportGraph.build(src_root)
    roots = list(roots)
    facade = graph.reachable_from(roots[:1])
    all_reachable = graph.reachable_from(roots)
    ext = _external_refs(external, graph.modules)
    # What an externally referenced module imports is kept alive by it.
    direct = {m: graph.reachable_from([m]) for m in ext}
    for mod in sorted(set().union(*direct.values()) - all_reachable
                      - set(direct)):
        ext[mod] = sorted(m for m, seen in direct.items() if mod in seen)

    classes: dict[str, dict] = {}
    for mod in sorted(graph.modules):
        if mod in facade:
            cls = "facade"
        elif mod in all_reachable:
            cls = "entrypoint"
        elif mod in ext:
            cls = "external-only"
        else:
            cls = "orphan"
        classes[mod] = {"class": cls, "path": graph.modules[mod]}
        if cls == "external-only":
            classes[mod]["referenced_by"] = ext[mod]

    counts: dict[str, int] = {}
    for info in classes.values():
        counts[info["class"]] = counts.get(info["class"], 0) + 1
    return {
        "roots": roots,
        "counts": counts,
        "modules": classes,
        "orphans": [m for m, i in classes.items() if i["class"] == "orphan"],
    }
