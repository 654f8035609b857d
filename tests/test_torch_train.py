"""The port's LM training path against the JAX package's, on the CPU.

The same weights (JAX's ``init_params``, loaded with `params_from_jax`)
and the same tokens (numpy, seeded) go through JAX's ``loss_fn`` /
``jax.grad`` and ``make_train_step`` and the port's autograd and
`make_train_step`. JAX runs as its own tests run it (x64 on, CPU, jitted).
Float32 compute throughout. Tolerances: gradients within 1e-5 of each
leaf's max |g|; a step's metrics within 1e-5 relative; the parameters and
moments of each of 3 steps, from JAX's state of the step before, within
rtol 2e-4, atol 2e-6 — the JAX package's own bound between two float32
paths of one step (``tests/test_train.py:53``) — plus the gradient's own
tolerance carried through Adam (`_adam_hold`). Checkpoints cross between the packages bit
for bit. The flash branch refuses autograd (it has no backward, in JAX
either), and every entry point defaults to the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _adam_hold import flat, hold_adam_step
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.train import step as jstep
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import DataMesh, make_host_mesh
from repro_torch.models import layers
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import (opt_state_from_jax,
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy, stack_to_tree)
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.train import (TrainState, init_state, make_eval_step,
                               make_train_step)


def _cfgs(name="qwen3-8b", **kw):
    over = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(jget_config(name, smoke=True), **over),
            dataclasses.replace(get_config(name, smoke=True), **over))


def _jparams(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(seed), jcfg))


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _close(got, want, rtol, atol, what=""):
    got, want = dict(_items(got)), dict(_items(want))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        np.testing.assert_allclose(got[key].astype(np.float64),
                                   want[key].astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {key}")


def _equal(got, want):
    got, want = dict(_items(got)), dict(_items(want))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _port_state(tree, tcfg, opt_cfg):
    model = params_from_jax(tree, tcfg, device="cpu")
    return TrainState(model=model, opt_state=adamw_init(model, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("name,remat", [("qwen3-8b", False),
                                        ("qwen3-8b", True),
                                        ("granite-3-8b", False),
                                        ("minicpm-2b", False)])
def test_loss_gradients_match_jax(name, remat):
    """Autograd of the port's ``loss_fn`` against ``jax.grad`` of JAX's:
    qwen3 (qk-norm; also under remat, JAX's ``jax.checkpoint`` and the
    port's ``torch.utils.checkpoint``), granite, and minicpm (tied
    embeddings: ``embed`` gets the lookup's and the head's gradients)."""
    jcfg, tcfg = _cfgs(name, remat=remat)
    tree = _jparams(jcfg, seed=1)
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 24))
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b), has_aux=True))(
        tree, {"tokens": jnp.asarray(tokens)})
    model = params_from_jax(tree, tcfg, device="cpu")
    loss_t, _ = model.loss_fn({"tokens": torch.from_numpy(tokens)})
    loss_t.backward()
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    got = stack_to_tree({n: p.grad for n, p in model.named_parameters()})
    want = dict(_items(jax.tree_util.tree_map(np.asarray, g_j)))
    got = dict(_items(got))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)
    if tcfg.tie_embeddings:
        assert "lm_head" not in want


@pytest.mark.parametrize("microbatch", [None, 2])
@pytest.mark.parametrize("orthogonal", [False, True])
def test_three_train_steps_match_jax(microbatch, orthogonal):
    """3 steps of ``make_train_step`` with ``warmup_cosine``: each step
    starts from JAX's state of the step before, its metrics (JAX's ``ce,
    aux, zloss, tokens, loss, grad_norm, lr``) are held within 1e-5
    relative, its parameters and moments at rtol 2e-4 and atol 2e-6 plus
    the gradient's tolerance carried through Adam
    (`_adam_hold.hold_adam_step`: 1e-6 of each leaf's largest, 4e-5 for
    the orthogonalized gradients), and the steps must count alike.

    Each step starts from JAX's state because two float32 backends do not
    run side by side through Adam (`_adam_hold`): left to run, an element
    stepped the other way changes the next forward, and the orthogonal
    update drifts apart — as JAX's own two float32 paths do (``microbatch``
    None against 2, with the orthogonal update)."""
    jcfg, tcfg = _cfgs()
    tree = _jparams(jcfg)
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
    rng = np.random.default_rng(3)
    for s in range(3):
        # Uniform tokens: a batch of 128 covers more than d_model = 64 rows
        # of the embedding, so its gradient has full column rank. On a
        # rank-deficient one (the pipeline's Zipf tokens cover fewer rows),
        # orthogonalize's R has zeros on its diagonal and the regularized
        # solve scales float32 dust by 1/eps = 1e6 in both packages alike.
        batch = {"tokens": rng.integers(0, tcfg.vocab, (4, 32))}
        before = jax.tree_util.tree_map(np.asarray, jstate)
        model = params_from_jax(before.params, tcfg, device="cpu")
        tstate = TrainState(model=model, opt_state=opt_state_from_jax(
            before.opt_state, model), step=torch.tensor(
            int(before.step), dtype=torch.int32))
        with jmesh:
            jstate, m_j = jfn(jstate, batch)
        out, m_t = tfn(tstate, batch)
        assert out is tstate
        assert set(m_t) == set(m_j) == {"ce", "aux", "zloss", "tokens",
                                        "loss", "grad_norm", "lr"}
        for key in m_j:
            want = float(m_j[key])
            assert abs(float(m_t[key]) - want) <= 1e-5 * abs(want), \
                (s, key, float(m_t[key]), want)
        after = jax.tree_util.tree_map(np.asarray, jstate)
        mom = opt_state_to_numpy(tstate.opt_state, tstate.model)
        hold_adam_step(
            {"params": flat(params_to_numpy(tstate.model)),
             "mu": flat(mom["mu"]), "nu": flat(mom["nu"])},
            {k: flat(before.opt_state[k]) for k in ("mu", "nu")},
            {"params": flat(after.params), "mu": flat(after.opt_state["mu"]),
             "nu": flat(after.opt_state["nu"])},
            step=s + 1, lr=float(m_j["lr"]), b1=t_opt.b1, b2=t_opt.b2,
            eps=t_opt.eps, tau=4e-5 if orthogonal else 1e-6,
            orthogonal=orthogonal)
        assert int(tstate.step) == int(after.step) == s + 1
        assert int(mom["step"]) == int(after.opt_state["step"]) == s + 1


def test_microbatch_metrics_are_the_last_micro_steps():
    """``microbatch=2``: the loss is the mean of the micro-steps' losses,
    the other metrics the last micro-step's (rows 1 and 3 of 4)."""
    _, tcfg = _cfgs()
    opt = AdamWConfig(lr=0.0)
    gen = torch.Generator().manual_seed(4)
    state = init_state(gen, tcfg, opt, device="cpu")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab, (4, 16))
    with torch.no_grad():
        l0, m0 = state.model.loss_fn({"tokens": torch.from_numpy(
            tokens[0::2])})
        l1, m1 = state.model.loss_fn({"tokens": torch.from_numpy(
            tokens[1::2])})
    _, m = make_train_step(tcfg, opt, microbatch=2, device="cpu")(
        state, {"tokens": tokens})
    assert abs(float(m["loss"]) - float((l0 + l1) / 2)) <= 1e-6
    for key in ("ce", "zloss", "tokens"):
        assert float(m[key]) == pytest.approx(float(m1[key]), rel=1e-6)
    with pytest.raises(ValueError, match="micro"):
        make_train_step(tcfg, opt, microbatch=3, device="cpu")(
            state, {"tokens": tokens})


def test_flash_branch_refuses_autograd_on_the_cpu():
    """The flash branch has no backward (JAX's ``jax.grad`` through its
    kernel fails): under autograd it raises, with or without remat, and
    nothing falls back to ``_attend``; without autograd it runs."""
    _, tcfg = _cfgs(use_flash_kernel=True, head_dim=32)
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(6))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(7).integers(0, tcfg.vocab, (2, 16)))}
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=True)):
        with pytest.raises(NotImplementedError, match="no backward"):
            model.loss_fn(batch, cfg)
    with torch.no_grad():
        loss, _ = model.loss_fn(batch)
    assert bool(torch.isfinite(loss))
    assert make_eval_step(tcfg, device="cpu")(model, batch)["loss"] == loss
    with pytest.raises(NotImplementedError, match="_attend"):
        make_train_step(tcfg, AdamWConfig(), device="cpu")


def test_remat_gives_the_same_step():
    """``remat=True`` checkpoints each super-block; the step it takes is
    the one without it."""
    _, tcfg = _cfgs()
    opt = AdamWConfig(lr=1e-2)
    batch = TokenPipeline(tcfg.vocab, 32, 2, seed=8).batch_at(0)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        state = init_state(torch.Generator().manual_seed(9), cfg, opt,
                           device="cpu")
        _, m = make_train_step(cfg, opt, device="cpu")(state, batch)
        out.append((m, params_to_numpy(state.model)))
    for key in out[0][0]:
        assert float(out[0][0][key]) == pytest.approx(float(out[1][0][key]),
                                                      rel=1e-6, abs=1e-9)
    _close(out[1][1], out[0][1], 2e-4, 2e-6)


def test_entry_points_default_to_the_card():
    _, tcfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(tcfg, AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(torch.Generator(), tcfg, AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()


def test_train_mesh_of_several_ranks_is_not_ported():
    _, tcfg = _cfgs()
    mesh = DataMesh(group=None, size=2, rank=0, device=torch.device("cpu"),
                    ranks=(0, 1), backend="gloo")
    with pytest.raises(NotImplementedError, match="A14.6"):
        make_train_step(tcfg, AdamWConfig(), mesh)
    one = make_host_mesh(device="cpu")
    assert one.size == 1 and one.device.type == "cpu"
    make_train_step(tcfg, AdamWConfig(), one)  # a one-rank mesh names its
    with pytest.raises(NotImplementedError, match="A14.6"):
        make_host_mesh(model=2, device="cpu")


# -- the token pipeline --------------------------------------------------------


@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_token_pipeline_is_bit_equal_to_jax(host):
    host_id, num_hosts = host
    ours = TokenPipeline(512, 24, 4, seed=11, host_id=host_id,
                         num_hosts=num_hosts)
    theirs = JTokenPipeline(512, 24, 4, seed=11, host_id=host_id,
                            num_hosts=num_hosts)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b) == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_token_pipeline_prefetch_resumes_at_step():
    p = TokenPipeline(128, 8, 2, seed=2)
    it = p.start(start_step=10)
    got = [next(it) for _ in range(3)]
    p.stop()
    assert not p._thread.is_alive()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"],
                                      p.batch_at(10 + i)["tokens"])


# -- checkpoints across the packages ------------------------------------------


def _jax_state_shape(jcfg, j_opt):
    state = jstep.init_state(jax.random.PRNGKey(0), jcfg, j_opt)
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    opt = AdamWConfig(lr=1e-2)
    state = init_state(torch.Generator().manual_seed(12), tcfg, opt,
                       device="cpu")
    step = make_train_step(tcfg, opt, device="cpu")
    for s in range(2):
        step(state, TokenPipeline(tcfg.vocab, 16, 2, seed=0).batch_at(s))
    CheckpointManager(str(tmp_path)).save(2, state, blocking=True)
    restored = JCheckpointManager(str(tmp_path)).restore(
        2, _jax_state_shape(jcfg, jadamw.AdamWConfig()))
    _equal(jax.tree_util.tree_map(np.asarray, restored.params),
           params_to_numpy(state.model))
    mom = opt_state_to_numpy(state.opt_state, state.model)
    for key in ("mu", "nu", "step"):
        _equal(jax.tree_util.tree_map(np.asarray, restored.opt_state[key]),
               mom[key])
    assert int(restored.step) == 2 and int(mom["step"]) == 2


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs()
    j_opt = jadamw.AdamWConfig(lr=1e-2)
    jstate = jstep.init_state(jax.random.PRNGKey(3), jcfg, j_opt)
    mesh = jmake_host_mesh()
    with mesh:
        jstate, _ = jax.jit(jstep.make_train_step(jcfg, j_opt, mesh))(
            jstate, JTokenPipeline(jcfg.vocab, 16, 2, seed=0).batch_at(0))
    JCheckpointManager(str(tmp_path)).save(1, jstate, blocking=True)
    target = init_state(torch.Generator().manual_seed(0), tcfg,
                        AdamWConfig(), device="cpu")
    step, got = CheckpointManager(str(tmp_path)).restore_latest(target)
    assert step == 1 and got is target
    _equal(params_to_numpy(got.model),
           jax.tree_util.tree_map(np.asarray, jstate.params))
    mom = opt_state_to_numpy(got.opt_state, got.model)
    for key in ("mu", "nu", "step"):
        _equal(mom[key], jax.tree_util.tree_map(np.asarray,
                                                jstate.opt_state[key]))
    assert int(got.step) == 1
    # and the restored state trains on as JAX's does
    j_tree = jax.tree_util.tree_map(np.asarray, jstate.params)
    assert opt_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state), got.model)["step"] == 1
    _equal(params_to_numpy(params_from_jax(j_tree, tcfg, device="cpu")),
           j_tree)


def test_async_save_holds_the_state_of_its_step(tmp_path):
    """The port updates parameters in place, and on the CPU ``.cpu()`` is
    the tensor itself: `save` copies to the host before it returns, so the
    steps taken while the writer runs do not reach the file."""
    _, tcfg = _cfgs()
    opt = AdamWConfig(lr=5e-2)
    state = init_state(torch.Generator().manual_seed(13), tcfg, opt,
                       device="cpu")
    step = make_train_step(tcfg, opt, device="cpu")
    pipe = TokenPipeline(tcfg.vocab, 16, 2, seed=1)
    step(state, pipe.batch_at(0))
    want = params_to_numpy(state.model)
    want_mu = opt_state_to_numpy(state.opt_state, state.model)["mu"]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)  # async
    for s in range(1, 3):
        step(state, pipe.batch_at(s))
    mgr.wait()
    moved = params_to_numpy(state.model)
    assert not np.array_equal(moved["embed"], want["embed"])
    fresh = init_state(torch.Generator().manual_seed(0), tcfg, opt,
                       device="cpu")
    mgr.restore(1, fresh)
    _equal(params_to_numpy(fresh.model), want)
    _equal(opt_state_to_numpy(fresh.opt_state, fresh.model)["mu"], want_mu)
    assert int(fresh.step) == 1


def test_checkpoint_of_plain_trees_and_its_checks(tmp_path):
    """A tree of tensors keeps JAX's keys; a shape mismatch raises; GC keeps
    the last ``keep``; no temporary file is left."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=True, extra_meta={"mesh": "1"})
    assert mgr.all_steps() == [2, 3]
    with np.load(tmp_path / "step_00000003.npz") as data:
        assert sorted(data.files) == ["a", "b/c"]
    assert not any(f.endswith(".tmp.npz") for f in
                   (p.name for p in tmp_path.iterdir()))
    target = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
        4, dtype=torch.bfloat16)}}
    out = mgr.restore(3, target)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(
        out["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, {"a": torch.zeros(3, 3), "b": {"c": torch.zeros(4)}})
    # JAX's manager reads the same file
    jt = JCheckpointManager(str(tmp_path)).restore(3, {
        "a": jax.ShapeDtypeStruct((2, 3), jnp.float32),
        "b": {"c": jax.ShapeDtypeStruct((4,), jnp.bfloat16)}})
    np.testing.assert_array_equal(np.asarray(jt["a"]), tree["a"].numpy())


def test_eval_step_takes_the_pipelines_int32_tokens():
    _, tcfg = _cfgs()
    model = Transformer(tcfg, device="cpu").init(
        torch.Generator().manual_seed(14))
    batch = TokenPipeline(tcfg.vocab, 16, 2, seed=0).batch_at(0)
    assert batch["tokens"].dtype == np.int32
    m = make_eval_step(tcfg, device="cpu")(model, batch)
    m64 = make_eval_step(tcfg, device="cpu")(
        model, {"tokens": batch["tokens"].astype(np.int64)})
    assert float(m["loss"]) == float(m64["loss"])
    assert layers.FLASH_NO_BACKWARD.startswith("use_flash_kernel=True")
