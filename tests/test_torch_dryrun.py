"""The port's dry run (``python -m repro_torch.launch.dryrun``) and roofline,
mirroring ``tests/test_dryrun.py``: the CLI in a subprocess (it starts a
fake world of 256 or 512 ranks of its own), reduced configs.

A smoke train cell on the single-pod mesh prints ``[ok]``; the skip rule
is JAX's; a serving cell writes an ``ok`` record with JAX's model FLOPs,
and a cut decode cell's FLOPs at (2, 2) are rank 0's count of a real decode
step in a spawned gloo world. The per-device FLOPs
are rank 0's: on a (1, 1) mesh they equal ``FlopCounterMode``'s count of
the real train step on the CPU at the same cut, exactly; on (2, 2) the
count rank 0 of a real (2, 2) gloo world takes of the same step (its two
data rows, the compute split over ``model``: four spawned ranks of
``tests/_torch_train_mesh_driver.py``). ``model_flops`` is JAX's
6·N_active·B·S, and the `Roofline` record has JAX's keys, with the H100's
constants in its terms.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_train_mesh_driver as driver
from repro.configs import ARCH_NAMES, get_config as jget_config
from repro.launch import roofline as jroofline
from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_state, make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _dryrun(args, ok=True, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"] + args
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if ok:
        assert out.returncode == 0, \
            f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out


def test_smoke_cell_single_pod():
    out = _dryrun(["--arch", "granite-3-8b", "--shape", "train_4k",
                   "--mesh", "single", "--smoke", "--out", ""])
    assert "[ok]" in out.stdout and "16x16" in out.stdout


def test_skip_rule_applies():
    out = _dryrun(["--arch", "qwen3-8b", "--shape", "long_500k",
                   "--mesh", "single", "--smoke", "--out", ""])
    assert "[skip]" in out.stdout


def test_serving_cells_raise_naming_the_next_item(tmp_path):
    """A serving cell (A14.8, ported): rwkv6's long_500k smoke cell on the
    multi-pod mesh, one sequence over 512 ranks, writes an ``ok`` record
    whose ``model_flops`` are JAX's 2·N_active·1 of a decode step."""
    _dryrun(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--mesh",
             "multi", "--smoke", "--out", str(tmp_path)])
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16", rec
    assert rec["model_flops"] == \
        2.0 * jget_config("rwkv6-1.6b", smoke=True).active_param_count()
    assert rec["peak_memory_per_device"] > 0


CUT = dict(arch="granite-3-8b", blocks=3, batch=4, seq=64)
assert CUT == driver.FLOPS_CUT


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The cut granite cell's records on the (1, 1) and (2, 2) meshes."""
    out = {}
    for mesh in ("1,1", "2,2"):
        d = tmp_path_factory.mktemp("dry" + mesh.replace(",", "x"))
        _dryrun(["--arch", CUT["arch"], "--shape", "train_4k", "--smoke",
                 "--host-mesh", mesh, "--blocks", str(CUT["blocks"]),
                 "--batch", str(CUT["batch"]), "--seq", str(CUT["seq"]),
                 "--out", str(d)])
        (path,) = d.iterdir()
        out[mesh] = json.loads(path.read_text())
    return out


@pytest.fixture(scope="module")
def gloo_flops(tmp_path_factory):
    """Rank 0's count of one train step of the cut in a (2, 2) gloo world
    of four spawned ranks."""
    tmp = tmp_path_factory.mktemp("flops2x2")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_train_mesh_driver.py"),
         str(r), "4", "2", str(tmp / "store"), "flops", str(tmp / "out.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with np.load(tmp / "out.npz") as f:
        return int(f["flops"])


import _torch_serve_mesh_driver as serve_driver  # noqa: E402

SERVE_CUT = serve_driver.FLOPS_CUT


@pytest.fixture(scope="module")
def decode_record(tmp_path_factory):
    """The cut decode cell's record on the (2, 2) mesh."""
    d = tmp_path_factory.mktemp("drydecode")
    _dryrun(["--arch", SERVE_CUT["arch"], "--shape", "decode_32k", "--smoke",
             "--host-mesh", "2,2", "--blocks", str(SERVE_CUT["blocks"]),
             "--batch", str(SERVE_CUT["batch"]), "--seq",
             str(SERVE_CUT["seq"]), "--out", str(d)])
    (path,) = d.iterdir()
    return json.loads(path.read_text())


def test_decode_flops_per_device_equal_the_real_step(decode_record,
                                                     tmp_path):
    """The cut decode cell's per-device FLOPs at (2, 2) are rank 0's count
    of a real decode step of the same cut (the dry run's cell config: bf16
    parameters, one attention block of the cache) in a (2, 2) gloo world
    of four spawned ranks (`tests/_torch_serve_mesh_driver.py`); its model
    FLOPs are 2·N_active·B."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_serve_mesh_driver.py"),
         str(r), "4", "2", "0", str(tmp_path / "store"), "flops",
         str(tmp_path / "out.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with np.load(tmp_path / "out.npz") as f:
        want = int(f["flops"])
    rec = decode_record
    assert rec["status"] == "ok", rec
    assert rec["flops_per_device"] == want
    jcfg = dataclasses.replace(jget_config(SERVE_CUT["arch"], smoke=True),
                               n_blocks=SERVE_CUT["blocks"])
    assert rec["model_flops"] == \
        2.0 * jcfg.active_param_count() * SERVE_CUT["batch"]


def _real_step_flops(rows: int) -> int:
    cfg = dataclasses.replace(get_config(CUT["arch"], smoke=True),
                              n_blocks=CUT["blocks"])
    opt = AdamWConfig()
    state = init_state(torch.Generator().manual_seed(0), cfg, opt,
                       device="cpu")
    step = make_train_step(cfg, opt, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (rows, CUT["seq"]))
    with FlopCounterMode(display=False) as fc:
        step(state, {"tokens": tokens})
    return fc.get_total_flops()


@pytest.mark.parametrize("mesh,rows", [("1,1", 4), ("2,2", 2)])
def test_flops_per_device_equal_the_real_steps(records, request, mesh,
                                               rows):
    """Rank 0's count of ``rows`` rows: at (1, 1) the whole batch in this
    process, at (2, 2) a data rank's half with the compute split over
    ``model`` in a real gloo world."""
    rec = records[mesh]
    assert rec["status"] == "ok", rec
    want = _real_step_flops(rows) if mesh == "1,1" else \
        request.getfixturevalue("gloo_flops")
    assert rec["flops_per_device"] == want
    coll = rec["coll_breakdown"]
    if mesh == "1,1":
        assert sum(coll.values()) == 0
    else:
        # granite's smoke config has no FSDP: no parameter is split over
        # ``data``, and none is gathered over ``model`` (its heads, ff and
        # vocab split there); the model axis's sums and the gradients' sum
        # over ``data`` are all-reduces.
        assert coll["all-gather"] == 0 and coll["all-reduce"] > 0
    assert rec["peak_memory_per_device"] > 0


def test_model_flops_are_jax(records):
    jcfg = dataclasses.replace(jget_config(CUT["arch"], smoke=True),
                               n_blocks=CUT["blocks"])
    want = 6.0 * jcfg.active_param_count() * CUT["batch"] * CUT["seq"]
    for rec in records.values():
        assert rec["model_flops"] == want
    for name in ARCH_NAMES:
        assert get_config(name).active_param_count() == \
            jget_config(name).active_param_count()


def test_record_keys_are_jax(records):
    kw = dict(arch="a", shape="s", mesh_name="m", chips=256,
              cost={"flops": 1e15, "bytes accessed": 4e12},
              coll={"all-gather": 10**9, "all-reduce": 2 * 10**9},
              peak_memory=5e9, model_flops=1e17)
    ours = roofline.build_roofline(**kw).to_json()
    theirs = jroofline.build_roofline(**kw).to_json()
    assert set(ours) == set(theirs)
    rec = records["2,2"]
    assert set(theirs) <= set(rec)
    assert {"status", "memory_analysis", "peak_memory_per_device",
            "lower_s", "compile_s", "cost_pass_s"} <= set(rec)


def test_roofline_terms_on_fixed_inputs():
    rl = roofline.build_roofline(
        arch="a", shape="s", mesh_name="16x16", chips=256,
        cost={"flops": 989e12 * 2.0, "bytes accessed": 3.35e12 * 0.5},
        record=[("all-gather", 450e9 * 0.25), ("reduce-scatter", 0)],
        peak_memory=1.0, model_flops=989e12 * 256 * 0.5)
    assert rl.compute_s == pytest.approx(2.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.collective_s == pytest.approx(0.25)
    assert rl.dominant == "compute" and rl.step_s == pytest.approx(2.0)
    assert rl.useful_flops_fraction == pytest.approx(0.25)
    assert rl.mfu == pytest.approx(0.25)
    assert rl.coll_breakdown["all-gather"] == int(450e9 * 0.25)
    assert set(rl.coll_breakdown) == {"all-gather", "all-reduce",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute"}
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_no_tpu_constant_in_the_port():
    """The TPU v5e figures (197 TFLOP/s, 819 GB/s, 50 GB/s ICI) appear
    nowhere in the port's sources."""
    pat = re.compile(r"\b197e12|\b819e9|\bICI_BW\b|\b50e9\b")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not pat.search(path.read_text()), path


@pytest.mark.parametrize("baseline", [False, True])
def test_options_change_only_what_the_port_reads(baseline):
    """``OPT_DEFAULTS`` (and ``--baseline``, every option off) rewrite only
    ``moe_groups``, and ``train_bf16`` the parameters' and moments' dtype:
    the other options name layouts the port does not have yet."""
    from repro_torch.launch import dryrun

    cfg = get_config("mixtral-8x22b", smoke=True)
    mesh = {"data": 16, "model": 16}
    opts = {k: False for k in dryrun.OPT_DEFAULTS} if baseline else None
    got = dryrun.cell_config(cfg, "train_4k", mesh, opts)
    assert got.moe_groups == (1 if baseline else 16)
    assert dataclasses.replace(got, moe_groups=cfg.moe_groups) == cfg
    bf = dryrun.cell_config(cfg, "train_4k", mesh,
                            dict(opts or {}, train_bf16=True))
    assert (bf.param_dtype, bf.opt_state_dtype) == ("bfloat16", "bfloat16")
    assert dataclasses.replace(bf, param_dtype=got.param_dtype,
                               opt_state_dtype=got.opt_state_dtype) == got
