"""Hold a port LM config to the JAX package's on the CPU: the checks the MoE,
state-space and encoder-decoder test files (`test_torch_moe.py`,
`test_torch_ssm.py`, `test_torch_enc_dec.py`) share.

Each takes an ``arch`` dict (`arch_fixture`): both packages' smoke config
with float32 compute, JAX's parameters (``init_params``, jitted, seed 1)
and their numpy tree. A batch holds the tokens and, where the config reads
them, the ``frames`` or ``patches`` `inputs` draws. Tolerances are the
callers', stated in their docstrings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _adam_hold import flat, hold_adam_step
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.launch.train import main as train_main
from repro_torch.models.weights import (cache_to_numpy, opt_state_from_jax,
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy, stack_to_tree)
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import TrainState, make_train_step

# JAX's init, jitted: op by op it takes seconds at these sizes.
jinit = jax.jit(jtf.init_params, static_argnums=1)


def cfgs(name, moe_over=None, **kw):
    """Both packages' smoke config, float32 compute, with ``kw`` and the
    MoE fields ``moe_over`` replaced."""
    over = {"compute_dtype": "float32", **kw}
    out = []
    for cfg in (jget_config(name, smoke=True), get_config(name, smoke=True)):
        if moe_over:
            over["moe"] = dataclasses.replace(cfg.moe, **moe_over)
        out.append(dataclasses.replace(cfg, **over))
    return tuple(out)


def arch_fixture(names):
    """A module-scoped fixture over ``names``: one config's JAX parameters,
    shared by the model tests of a module."""

    @pytest.fixture(scope="module", params=names)
    def arch(request):
        jcfg, tcfg = cfgs(request.param)
        params = jinit(jax.random.PRNGKey(1), jcfg)
        return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
                "params": params,
                "tree": jax.tree_util.tree_map(np.asarray, params)}

    return arch


def inputs(cfg, tokens, seed=7, frames=None):
    """``{"tokens": tokens}`` (numpy) with the ``"frames"`` [B, T, d] of an
    encoder-decoder (T = ``frames``, default ``cfg.encoder_len``) and the
    ``"patches"`` [B, patch_positions, d] of a patch config, standard
    normal float32 from numpy ``seed``, as the JAX package's smoke tests
    draw them (`tests/test_models_smoke.py`)."""
    rng = np.random.default_rng(seed)
    b = tokens.shape[0]
    out = {"tokens": tokens}
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal(
            (b, frames or cfg.encoder_len, cfg.d_model), np.float32)
    if cfg.patch_positions:
        out["patches"] = rng.standard_normal(
            (b, cfg.patch_positions, cfg.d_model), np.float32)
    return out


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def np_tree(tree):
    """A JAX tree as numpy, bfloat16 widened to float32."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32)
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a), tree)


def forward_and_aux(arch, t):
    """Logits within 1e-4 of max |logits|, aux within 1e-6 relative (exactly
    0 in both without MoE layers), over 2 × ``t`` tokens (after the
    patches of a patch config, whose count is the offset)."""
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    batch = inputs(tcfg, np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, t)))
    logits_j, aux_j, off_j = jax.jit(jtf.forward, static_argnums=1)(
        arch["params"], jcfg, jbatch(batch))
    model = params_from_jax(arch["tree"], tcfg, device="cpu")
    with torch.no_grad():
        logits_t, aux_t, off = model(tbatch(batch))
    assert off == off_j == tcfg.patch_positions
    assert logits_t.shape == logits_j.shape
    assert rel(logits_t.numpy(), logits_j) < 1e-4
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6 * abs(float(aux_j))
    return float(aux_j)


def loss_gradients(arch, t, tol):
    """Autograd of the port's ``loss_fn`` against ``jax.grad`` over 2 ×
    ``t`` tokens: the loss within 1e-5 relative, each leaf within ``tol``
    of its max |g|. Returns the leaves' names."""
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    batch = inputs(tcfg, np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, t)))
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b), has_aux=True))(
        arch["tree"], jbatch(batch))
    model = params_from_jax(arch["tree"], tcfg, device="cpu")
    loss_t, _ = model.loss_fn(tbatch(batch))
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(
        float(loss_j))
    got = dict(items(stack_to_tree(
        {n: p.grad for n, p in model.named_parameters()})))
    want = dict(items(jax.tree_util.tree_map(np.asarray, g_j)))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=tol * np.abs(w).max(),
                                   err_msg=key)
    return set(want)


def check_cache(got, want, tol):
    """Every leaf of every kind of the port's cache against JAX's:
    positions exactly, the rest within ``tol`` of their max |value|."""
    got, want = cache_to_numpy(got), np_tree(want)
    assert set(got["blocks"]) == set(want["blocks"])
    for j, sub in want["blocks"].items():
        assert set(got["blocks"][j]) == set(sub)
        for kind, leaves in sub.items():
            assert set(got["blocks"][j][kind]) == set(leaves)
            for name, leaf in leaves.items():
                mine = got["blocks"][j][kind][name]
                assert mine.shape == leaf.shape, (j, kind, name)
                if name == "pos":
                    np.testing.assert_array_equal(mine, leaf)
                else:
                    assert rel(mine, leaf) < tol, (j, kind, name)
    assert int(got["pos"]) == int(want["pos"])


def prefill_and_decode(arch, prompt, steps, max_len=32, frames=None):
    """Prefill ``prompt`` tokens (after a patch config's patches, with an
    encoder-decoder's ``frames`` frames, `inputs`), then ``steps``
    teacher-forced decode steps in both packages: logits within 1e-4 of
    max |logits| and every cache leaf (`check_cache` at 1e-4) after each
    call; the port's cache written in place."""
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab,
                                               (2, prompt + steps))
    first = inputs(tcfg, tokens[:, :prompt], frames=frames)
    model = params_from_jax(arch["tree"], tcfg, device="cpu")
    lj, cj = jax.jit(jtf.prefill, static_argnums=(1, 3))(
        arch["params"], jcfg, jbatch(first), max_len)
    lt, ct = model.prefill(tbatch(first), max_len)
    assert rel(lt.numpy(), lj) < 1e-4
    check_cache(ct, cj, 1e-4)
    jdecode = jax.jit(jtf.decode_step, static_argnums=1)
    for j in range(prompt, tokens.shape[1]):
        tok = tokens[:, j:j + 1]
        lj, cj = jdecode(arch["params"], jcfg, cj, jnp.asarray(tok,
                                                               jnp.int32))
        lt, ct2 = model.decode_step(ct, torch.from_numpy(tok))
        assert ct2 is ct
        assert rel(lt.numpy(), lj) < 1e-4, j
        check_cache(ct, cj, 1e-4)


def three_train_steps(name, *, orthogonal, tau, microbatch=None):
    """3 steps of ``make_train_step`` (``microbatch`` micro-steps each) with
    ``warmup_cosine`` on ``name``'s smoke config over batches of 4 × 32
    tokens (with `inputs`), each from JAX's state of the step before: the
    metrics within 1e-5 relative, parameters and moments at rtol 2e-4,
    atol 2e-6 plus the gradient's tolerance ``tau`` (of each leaf's
    largest) carried through Adam (`_adam_hold.hold_adam_step`)."""
    jcfg, tcfg = cfgs(name)
    tree = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(5), jcfg))
    j_opt = jadamw.AdamWConfig(lr=jschedules.warmup_cosine(3e-3, 2, 10))
    t_opt = AdamWConfig(lr=warmup_cosine(3e-3, 2, 10))
    jmesh = jmake_host_mesh()
    jfn = jax.jit(jstep.make_train_step(jcfg, j_opt, jmesh,
                                        microbatch=microbatch,
                                        orthogonal_update=orthogonal))
    jstate = jstep.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        opt_state=jadamw.adamw_init(tree, j_opt),
        step=jnp.zeros((), jnp.int32))
    tfn = make_train_step(tcfg, t_opt, microbatch=microbatch,
                          orthogonal_update=orthogonal, device="cpu")
    rng = np.random.default_rng(6)
    for s in range(3):
        batch = inputs(tcfg, rng.integers(0, tcfg.vocab, (4, 32)), seed=s)
        before = jax.tree_util.tree_map(np.asarray, jstate)
        model = params_from_jax(before.params, tcfg, device="cpu")
        tstate = TrainState(model=model, opt_state=opt_state_from_jax(
            before.opt_state, model), step=torch.tensor(
            int(before.step), dtype=torch.int32))
        with jmesh:
            jstate, m_j = jfn(jstate, batch)
        out, m_t = tfn(tstate, batch)
        assert out is tstate
        for key in m_j:
            want = float(m_j[key])
            assert abs(float(m_t[key]) - want) <= 1e-5 * abs(want), (s, key)
        after = jax.tree_util.tree_map(np.asarray, jstate)
        mom = opt_state_to_numpy(tstate.opt_state, tstate.model)
        hold_adam_step(
            {"params": flat(params_to_numpy(tstate.model)),
             "mu": flat(mom["mu"]), "nu": flat(mom["nu"])},
            {k: flat(before.opt_state[k]) for k in ("mu", "nu")},
            {"params": flat(after.params), "mu": flat(after.opt_state["mu"]),
             "nu": flat(after.opt_state["nu"])},
            step=s + 1, lr=float(m_j["lr"]), b1=t_opt.b1, b2=t_opt.b2,
            eps=t_opt.eps, tau=tau, orthogonal=orthogonal)
        assert int(tstate.step) == int(after.step) == s + 1


def driver_resumes(name, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <name> --smoke`` on the
    CPU: 4 steps with a checkpoint at 2, then a restart that resumes from
    step 4 and runs 4->6 with finite losses."""
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", name, "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ckpt, "--ckpt-every", "2", "--log-every", "1",
            "--warmup", "1", "--device", "cpu"]
    assert train_main(args + ["--steps", "4"]) == 0
    assert "step     4" in capsys.readouterr().out
    assert train_main(args + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "steps 4->6" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
