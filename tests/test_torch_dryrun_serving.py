"""The dry run's serving cells at smoke size: every arch × prefill_32k,
decode_32k and long_500k on the single-pod (16 × 16) and multi-pod
(2 × 16 × 16) meshes writes an ``ok`` record with JAX's model FLOPs, or
is skipped by JAX's rule. One ``python -m repro_torch.launch.dryrun``
process runs each shape's archs on both meshes.

jamba-v0.1-52b's and rwkv6-1.6b's prefill_32k are left out: their memory
pass walks 512 chunks of the recurrence per layer on fake tensors (about
two minutes for rwkv6 and ten for jamba on a CPU), far past this file's
time.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import ARCH_NAMES, SHAPES, cell_is_runnable
from repro.configs import get_config as jget_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
SERVING = ("prefill_32k", "decode_32k", "long_500k")
SLOW = {("jamba-v0.1-52b", "prefill_32k"), ("rwkv6-1.6b", "prefill_32k")}
MESHES = ("16x16", "2x16x16")
CELLS = [(a, s) for s in SERVING for a in ARCH_NAMES if (a, s) not in SLOW]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per shape: the records the dry run wrote, and its stdout."""
    cache = {}

    def run(shape):
        if shape not in cache:
            out = tmp_path_factory.mktemp("serve_" + shape)
            archs = [a for a, s in CELLS if s == shape]
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--shape", shape, "--arch", *archs, "--mesh", "both",
                 "--smoke", "--out", str(out)],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            assert proc.returncode == 0, \
                f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
            recs = {p.name: json.loads(p.read_text()) for p in out.iterdir()}
            cache[shape] = (recs, proc.stdout)
        return cache[shape]

    return run


@pytest.mark.parametrize("arch,shape", CELLS)
def test_serving_smoke_cell_is_ok_or_skipped_as_jax(runs, arch, shape):
    recs, stdout = runs(shape)
    cfg = jget_config(arch, smoke=True)
    spec = SHAPES[shape]
    runnable, _ = cell_is_runnable(cfg, spec)
    for mesh in MESHES:
        name = f"{arch}__{shape}__{mesh}.json"
        if not runnable:
            assert name not in recs
            assert f"[skip] {arch} × {shape} × {mesh}" in stdout
            continue
        rec = recs[name]
        assert rec["status"] == "ok", rec
        assert rec["peak_memory_per_device"] > 0
        tokens = spec.seq_len if spec.kind == "prefill" else 1
        assert rec["model_flops"] == \
            2.0 * cfg.active_param_count() * spec.global_batch * tokens
        if mesh == "16x16":  # the roofline is single-pod, as JAX's
            assert rec["flops_per_device"] > 0
