"""The port's LM training over several gloo ranks against the JAX package's
one-device step, on the CPU.

Two worlds, spawned once and side by side
(`tests/_torch_train_mesh_driver.py`, one process per rank): 2 ranks as
the (2, 1) ``("data", "model")`` mesh and 4 as (2, 2), where the model
axis splits every layer's compute (tensor parallelism). For every case of
the driver's ``CASES`` — qwen3 smoke with an uneven ``loss_mask`` and the
orthogonal update (FSDP over ``data``), with ``microbatch=2`` and one head
(at (2, 2) the row-parallel fallback: its attention weights split over
``("model", "data")``), with one kv head (``wk``/``wv`` held whole over
``model``); mixtral smoke at ``moe_groups`` 1 with forced drops
(``capacity_factor`` 0.25; its group spans both data ranks), at
``moe_groups`` 2 (a group a data rank) — at (2, 2) its 4 experts split
over ``model`` — and with 3 experts (the ff dim split instead); jamba
smoke (mamba and MoE); rwkv6 smoke; whisper smoke with frames; minicpm
smoke (tied embeddings) — the ranks take two steps of ``make_train_step``
over the mesh, each from the JAX package's state of the step before, on
the same global batch JAX's jitted one-device step takes. Held as in
``tests/test_torch_train.py``: the metrics (JAX's global ``ce, aux,
zloss, tokens, loss, grad_norm, lr``) within 1e-5 relative (``grad_norm``
within the gradient's own tolerance where it is larger), the gathered
parameters and moments at rtol 2e-4, atol 2e-6 plus the gradient's
tolerance carried through Adam (`_adam_hold.hold_adam_step`: 1e-6 of each
leaf's largest, 4e-5 with the orthogonal update, rwkv6's 1e-4 and jamba's
1e-5 of ``tests/test_torch_ssm.py``). The (2, 2) world also checkpoints
its first step: every rank saves, rank 0 writes, and the file restores bit
for bit into a sharded state (in the driver), on one rank of the port and
in the JAX package; so does the (2, 1) world's.

At (2, 2) the world also runs the eval forward (``make_eval_step(mesh=,
logits=True)``) of every case of the driver's ``EVALS`` — the ten archs'
smoke configs (tied embeddings, patches, frames, mamba, MoE, RWKV) and
attention's and RWKV's other splits — held to JAX's ``forward`` (logits
within 1e-5 of their max |value|) and ``loss_fn`` (metrics within 1e-5
relative) on the same weights and batch; its record of collectives shows
no parameter gathered over ``model`` but the leaves
``repro_torch.sharding.placement`` lists.
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_mesh_driver as driver
from _adam_hold import flat, hold_adam_step
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.train import step as jstep
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import opt_state_to_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import placement

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLDS = {"2x1": (2, 1), "2x2": (4, 2)}
TAU = {"qwen_mask_orth": 4e-5, "rwkv": 1e-4, "jamba": 1e-5}


def _inputs(cfg, name, rng):
    case = driver.CASES[name]
    rows, seq = case["rows"], case["seq"]
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(
        np.int32)}
    if case.get("mask"):
        # Rank 0's rows keep few tokens, rank 1's most: a mean per rank,
        # averaged over the ranks, is not the global mean.
        keep = np.array([0.15, 0.3, 0.9, 1.0])[:, None]
        batch["loss_mask"] = (rng.random((rows, seq)) < keep).astype(
            np.float32)
    return _extra(cfg, batch, rng)


def _extra(cfg, batch, rng):
    """``batch`` with an encoder-decoder's frames or a patch config's
    patches, standard normal from ``rng``."""
    rows = batch["tokens"].shape[0]
    if cfg.is_enc_dec:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_len, cfg.d_model), np.float32)
    if cfg.patch_positions:
        batch["patches"] = rng.standard_normal(
            (rows, cfg.patch_positions, cfg.d_model), np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference():
    """(the driver's input ``.npz`` contents, {case: [(before, after,
    metrics)] a step}): JAX's jitted one-device steps."""
    given, steps = {}, {}
    jmesh = jmake_host_mesh()
    for i, (name, case) in enumerate(driver.CASES.items()):
        jcfg = driver.case_cfg(jget_config, name)
        j_opt = jadamw.AdamWConfig(lr=jschedules.warmup_cosine(*driver.LR))
        # The port's init (JAX's would compile once a config): the same
        # weights for both packages all the same.
        params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
            Transformer(driver.case_cfg(get_config, name), device="cpu").init(
                torch.Generator().manual_seed(10 + i))))
        jstate = jstep.TrainState(params=params,
                                  opt_state=jadamw.adamw_init(params, j_opt),
                                  step=jnp.zeros((), jnp.int32))
        jfn = jax.jit(jstep.make_train_step(
            jcfg, j_opt, jmesh, microbatch=case.get("micro"),
            orthogonal_update=bool(case.get("orth"))))
        rng = np.random.default_rng(20 + i)
        steps[name] = []
        for s in range(driver.STEPS):
            batch = _inputs(jcfg, name, rng)
            before = jax.tree_util.tree_map(np.asarray, jstate)
            given.update(driver.flatten(before.params, f"{name}/{s}/params"))
            given.update(driver.flatten(
                {k: before.opt_state[k] for k in ("mu", "nu", "step")},
                f"{name}/{s}/opt"))
            given[f"{name}/{s}/step"] = np.asarray(before.step)
            given.update(driver.flatten(batch, f"{name}/{s}/batch"))
            with jmesh:
                jstate, m = jfn(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
            after = jax.tree_util.tree_map(np.asarray, jstate)
            steps[name].append((before, after, {k: float(v)
                                                for k, v in m.items()}))
    return given, steps


@functools.lru_cache(maxsize=None)
def _eval_reference():
    """(the eval cases' ``.npz`` inputs, {case: (JAX's logits, JAX's
    metrics)}): JAX's jitted ``forward`` and ``loss_fn`` on the port's
    init of each case's config."""
    given, want = {}, {}
    for i, name in enumerate(driver.EVALS):
        jcfg = driver.case_cfg(jget_config, name, driver.EVALS)
        tcfg = driver.case_cfg(get_config, name, driver.EVALS)
        tree = params_to_numpy(Transformer(tcfg, device="cpu").init(
            torch.Generator().manual_seed(40 + i)))
        rng = np.random.default_rng(60 + i)
        batch = _extra(jcfg, {"tokens": rng.integers(
            0, jcfg.vocab, (driver.EVAL_ROWS, driver.EVAL_SEQ)).astype(
            np.int32)}, rng)
        given.update(driver.flatten(tree, f"eval/{name}/params"))
        given.update(driver.flatten(batch, f"eval/{name}/batch"))
        logits, (loss, metrics) = jax.jit(
            lambda p, b, c=jcfg: (jtf.forward(p, c, b)[0],
                                  jtf.loss_fn(p, c, b)))(
            jax.tree_util.tree_map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
        want[name] = (np.asarray(logits), dict(
            {k: float(v) for k, v in metrics.items()}, loss=float(loss)))
    return given, want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, spawned at once: each one's rank 0's results and its
    checkpoint dir."""
    given = dict(_reference()[0], **_eval_reference()[0])
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, str(REPO / "tests" / "_torch_train_mesh_driver.py")]
    procs, dirs = {}, {}
    for key, (size, model) in WORLDS.items():
        tmp = dirs[key] = tmp_path_factory.mktemp(f"mesh{key}")
        np.savez(tmp / "in.npz", **given)
        procs[key] = [subprocess.Popen(
            cmd + [str(r), str(size), str(model), str(tmp / "store"),
                   str(tmp / "in.npz"), str(tmp / "out.npz"),
                   str(tmp / "ckpt")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(size)]
    logs = {}
    try:
        for key, ranks in procs.items():
            logs[key] = [p.communicate(timeout=300)[0] for p in ranks]
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    out = {}
    for key, ranks in procs.items():
        report = "\n".join(f"--- {key} rank {r} ---\n{log}"
                           for r, log in enumerate(logs[key]))
        assert all(p.returncode == 0 for p in ranks), report
        with np.load(dirs[key] / "out.npz") as f:
            out[key] = {"name": key, "out": dict(f),
                        "ckpt": str(dirs[key] / "ckpt")}
    return out


@pytest.fixture(params=list(WORLDS))
def world(request, worlds):
    return worlds[request.param]


@pytest.mark.parametrize("name", list(driver.CASES))
def test_mesh_steps_match_jax(world, name):
    """Two steps of the case over the world's mesh, each from JAX's state
    of the step before, against JAX's one-device step."""
    _, steps = _reference()
    out = world["out"]
    opt = AdamWConfig()
    for s, (before, after, m_j) in enumerate(steps[name]):
        got = driver.unflatten(out, f"{name}/{s}")
        for key, want in m_j.items():
            have = float(got["metrics"][key])
            tol = max(1e-5, TAU.get(name, 0)) if key == "grad_norm" else 1e-5
            assert abs(have - want) <= tol * abs(want), \
                (world["name"], name, s, key, have, want)
        hold_adam_step(
            {"params": flat(got["params"]), "mu": flat(got["mu"]),
             "nu": flat(got["nu"])},
            {k: flat(before.opt_state[k]) for k in ("mu", "nu")},
            {"params": flat(after.params), "mu": flat(after.opt_state["mu"]),
             "nu": flat(after.opt_state["nu"])},
            step=s + 1, lr=m_j["lr"], b1=opt.b1, b2=opt.b2, eps=opt.eps,
            tau=TAU.get(name, 1e-6), orthogonal=bool(
                driver.CASES[name].get("orth")))
        assert int(got["step"]) == int(after.step) == s + 1


@pytest.mark.parametrize("name", list(driver.EVALS))
def test_eval_over_the_model_axis_matches_jax(worlds, name):
    """The eval forward at (2, 2), every layer split over ``model``: the
    global batch's logits, gathered over ``model`` and the data ranks,
    within 1e-5 of the max |logit| of JAX's ``forward``, and the metrics
    within 1e-5 relative of JAX's ``loss_fn``."""
    logits_j, m_j = _eval_reference()[1][name]
    got = driver.unflatten(worlds["2x2"]["out"], f"eval/{name}")
    assert got["logits"].shape == logits_j.shape
    err = np.abs(got["logits"].astype(np.float64) - logits_j).max()
    assert err <= 1e-5 * np.abs(logits_j).max(), (name, err)
    for key, want in m_j.items():
        have = float(got["metrics"][key])
        assert abs(have - want) <= 1e-5 * abs(want), (name, key, have, want)


def test_the_forward_gathers_over_model_only_the_listed_leaves(worlds):
    """The (2, 2) eval forwards' all-gathers over ``model``: the parameters
    among them are leaves `placement.GATHERED_OVER_MODEL` names (listed in
    the module's docstring) — mamba's ``in_proj`` and, where the heads do
    not divide the axis, RWKV's ``w*`` — and nothing else; the rest are
    activations split as a leaf (the logits, the row-parallel output)."""
    allowed = placement.GATHERED_OVER_MODEL
    for leaf in allowed:
        assert f"``{leaf}``" in placement.__doc__, leaf
    seen = {}
    for name in driver.EVALS:
        labels = [str(x) for x in
                  worlds["2x2"]["out"][f"eval/{name}/gathered"] if str(x)]
        params = {x[len("model:"):] for x in labels
                  if not x.endswith(":out")}
        bad = [p for p in params if not p.endswith(allowed)]
        assert not bad, (name, bad)
        seen[name] = params
    assert {p.rsplit(".", 1)[1] for p in seen["jamba-v0.1-52b"]} == \
        {"in_proj"}
    assert {p.rsplit(".", 1)[1] for p in seen["rwkv_one_head"]} == \
        {"wr", "wk", "wv", "wg", "wo"}
    assert all(not seen[n] for n in driver.EVALS
               if n not in ("jamba-v0.1-52b", "rwkv_one_head"))


def test_mixtral_drop_case_oversubscribes_its_experts():
    """The forced-drops case: one group of the global batch's 64 tokens,
    top-2 of 4 experts, 8 slots an expert — 128 assignments for 32 slots,
    so most drop, and which ones depends on the tokens of both data
    ranks."""
    from repro_torch.models import moe

    cfg = driver.case_cfg(get_config, "mixtral_drop")
    case = driver.CASES["mixtral_drop"]
    n = case["rows"] * case["seq"]
    assert moe.capacity(cfg, n) == (1, 8)
    assert cfg.moe.num_experts * 8 < n * cfg.moe.top_k


def test_mesh_checkpoint_restores_on_one_rank_and_in_jax(world):
    """The world's checkpoint of its first step (written at (2, 1) and at
    (2, 2)): the port restores it onto one rank, the JAX package onto its
    own state, both equal to the state the ranks gathered, bit for bit."""
    name = next(iter(driver.CASES))
    want = driver.unflatten(world["out"], f"{name}/0")
    tcfg = driver.case_cfg(get_config, name)
    model = Transformer(tcfg, device="cpu")
    from repro_torch.train import TrainState

    target = TrainState(model=model, opt_state=adamw_init(model,
                                                          AdamWConfig()),
                        step=torch.zeros((), dtype=torch.int32))
    step, got = CheckpointManager(world["ckpt"]).restore_latest(target)
    assert step == 1 and int(got.step) == 1
    mom = opt_state_to_numpy(got.opt_state, got.model)
    for key, tree in (("params", params_to_numpy(got.model)),
                      ("mu", mom["mu"]), ("nu", mom["nu"])):
        a, b = flat(tree), flat(want[key])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jcfg = driver.case_cfg(jget_config, name)
    shape = jax.eval_shape(lambda: jstep.init_state(
        jax.random.PRNGKey(0), jcfg, jadamw.AdamWConfig()))
    restored = JCheckpointManager(world["ckpt"]).restore(1, shape)
    for key, tree in (("params", restored.params),
                      ("mu", restored.opt_state["mu"]),
                      ("nu", restored.opt_state["nu"])):
        a = flat(jax.tree_util.tree_map(np.asarray, tree))
        b = flat(want[key])
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(restored.step) == 1


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x22b"])
def test_one_rank_mesh_step_is_the_mesh_less_step_bit_for_bit(arch):
    """A one-rank `make_host_mesh`: the state's placement holds every
    parameter whole, and the step, which runs the mesh path's gathers,
    reductions and norm with nothing to exchange, computes the mesh-less
    step's metrics, parameters and moments bit for bit over two steps with
    micro-steps and the orthogonal update."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import init_state, make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32", fsdp=True,
                              remat=True)
    opt = AdamWConfig(lr=warmup_cosine(3e-3, 1, 10))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 32))}
               for _ in range(2)]
    runs = []
    for mesh in (None, make_host_mesh(device="cpu")):
        state = init_state(torch.Generator().manual_seed(2), cfg, opt,
                           device="cpu", mesh=mesh)
        step = make_train_step(cfg, opt, mesh, microbatch=2,
                               orthogonal_update=True, device="cpu")
        runs.append(([step(state, b)[1] for b in batches], state))
    (m0, s0), (m1, s1) = runs
    assert s1.placement is not None and s1.placement.mesh.size == 1
    for a, b in zip(m0, m1):
        assert {k: float(v) for k, v in a.items()} == \
            {k: float(v) for k, v in b.items()}
    for (n, p), (_, q) in zip(s0.model.named_parameters(),
                              s1.model.named_parameters()):
        assert torch.equal(p, q), n
    for key in ("mu", "nu"):
        for n, t in s0.opt_state[key].items():
            assert torch.equal(t, s1.opt_state[key][n]), (key, n)


def test_driver_trains_over_two_ranks_and_resumes_on_one(tmp_path):
    """``python -m repro_torch.launch.train`` as ``torchrun`` starts it (the
    environment's RANK, WORLD_SIZE and a localhost store) on two gloo
    ranks with ``--model-parallel 2``: rank 0 alone logs, the checkpoint is
    written once; a run on one rank resumes from it and trains on."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ckpt = str(tmp_path / "ckpt")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "qwen3-8b", "--smoke", "--batch", "4", "--seq",
            "16", "--ckpt-dir", ckpt, "--ckpt-every", "2", "--log-every", "1",
            "--warmup", "1"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2")
    procs = [subprocess.Popen(
        args + ["--steps", "2", "--model-parallel", "2"], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    assert "step     2" in logs[0] and "step " not in logs[1]
    assert sorted(os.listdir(ckpt)) == ["step_00000002.json",
                                        "step_00000002.npz"]
    one = subprocess.run(args + ["--steps", "4"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stdout + one.stderr
    assert "resumed from step 2" in one.stdout and "steps 2->4" in one.stdout
