"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` has a plain C interface and is
compiled on first use into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``) as ``lib<name>-<hash>.so``, where the hash is that
of the source text, of the headers it includes from ``csrc/`` (``#include
"x.cuh"``, followed transitively) and of the compiler flags: an edited source
or header builds anew, an unchanged one is loaded as it is. `build_all` starts one ``nvcc`` per source
at once and waits for all of them.

The flags build for Hopper only (``sm_90a``). Nothing here runs when a
module is imported: hosts that run only the CPU tests have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

from repro_torch.sanitizer.locks import san_lock

__all__ = ["SOURCES", "build_dir", "library", "library_path", "build_all"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
SOURCES = ("node_fused", "panel_qr", "head_tail", "flash_attn",
           "flash_attn_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = san_lock("build._lock")
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc's output (ptxas register report)


def build_dir() -> pathlib.Path:
    return _PKG.parent.parent / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of repro_torch are built with it at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(src: pathlib.Path) -> list[pathlib.Path]:
    """``src`` and every header of ``csrc/`` it includes, transitively."""
    seen = [src]
    for path in seen:
        for name in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / name.decode()).resolve()
            if header.is_file() and header not in seen:
                seen.append(header)
    return seen


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources_of(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def library_path(name: str) -> pathlib.Path:
    """Where the library of one source is (or will be) built."""
    return _target(name)[1]


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (output path, process or None)."""
    src, out = _target(name)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, (proc, tmp)


def _finish(name: str, out: pathlib.Path, job) -> str:
    """Wait for one nvcc; returns its output."""
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> None:
    """Build every named source in parallel (one nvcc each) and load them."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        jobs = [(n, *_start(n)) for n in todo]
        for name, out, job in jobs:
            BUILD_LOG[name] = _finish(name, out, job)
        for name, out, _ in jobs:
            _libs[name] = ctypes.CDLL(str(out))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib
