"""Import isolation: the port needs neither JAX nor the JAX package.

A subprocess blocks ``jax`` and ``repro`` in ``sys.modules`` (an import of
either then raises) and imports every module of ``repro_torch``; a text check
finds no ``import jax`` / ``from repro`` / ``import repro`` (other than
``repro_torch``) in the port's sources, in ``chip_smoke.py`` or in ``tools/``.
"""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
    re.MULTILINE)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    for name in ("repro_torch.core.engine", "repro_torch.api",
                 "repro_torch.models.transformer", "repro_torch.models.weights",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.configs", "repro_torch.configs.qwen3_8b",
                 "repro_torch.train.step", "repro_torch.kernels.head_tail.ops",
                 "repro_torch.kernels.flash_attn.kernel",
                 "repro_torch.figaro", "repro_torch.core.plan_cache",
                 "repro_torch.train.async_serve", "repro_torch.train.serve",
                 "repro_torch.launch", "repro_torch.launch.mesh",
                 "repro_torch.core.distributed",
                 "repro_torch.sanitizer",
                 "repro_torch.sanitizer._state", "repro_torch.sanitizer.locks",
                 "repro_torch.sanitizer.races",
                 "repro_torch.sanitizer.threads",
                 "repro_torch.sanitizer.retrace",
                 "repro_torch.sanitizer.numerics", "repro_torch.planner",
                 "repro_torch.planner.stats", "repro_torch.planner.cost",
                 "repro_torch.planner.orient", "repro_torch.planner.explain",
                 "repro_torch.planner.replan", "repro_torch.optim",
                 "repro_torch.optim.adamw", "repro_torch.optim.schedules",
                 "repro_torch.optim.orthogonal",
                 "repro_torch.optim.compression",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.launch.train", "repro_torch.sharding",
                 "repro_torch.sharding.rules",
                 "repro_torch.sharding.placement",
                 "repro_torch.sharding.collectives",
                 "repro_torch.launch.roofline", "repro_torch.launch.dryrun"):
        assert name in mods, name
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {mods!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_or_repro_imports_in_port_sources():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("*.py")))
    assert (REPO / "chip_smoke.py").exists()
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in files
                 for m in _FORBIDDEN.finditer(p.read_text(encoding="utf-8"))]
    assert not offenders, offenders


def test_forbidden_pattern_catches_what_it_should():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from repro.core import engine")
    assert _FORBIDDEN.search("import repro")
    assert not _FORBIDDEN.search("from repro_torch.core import engine")
    assert not _FORBIDDEN.search("import repro_torch")
