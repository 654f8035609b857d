"""The port's mixture-of-experts layer and the MoE configs (mixtral-8x22b,
arctic-480b) against the JAX package's, on the CPU.

The same weights (JAX's ``init_moe`` / ``init_params``, carried across as
numpy) and the same inputs (numpy, seeded) go through JAX's ``apply_moe``,
``forward``, ``loss_fn``/``jax.grad``, ``prefill``/``decode_step`` and
``make_train_step`` and the port's (`_lm_parity`). JAX runs as the suite
runs it (x64 on, CPU). Float32 compute throughout, at the smoke configs.
Tolerances: the layer's output within 1e-5 of its max |y| and ``aux``
within 1e-6 relative (the same float32 operations, rounded apart); logits,
prefill and decode within `tests/test_torch_lm.py`'s 1e-4 of max |logits|,
caches leaf by leaf at the same bound (positions exactly); gradients at
``tests/test_torch_train.py``'s bound (loss within 1e-5 relative, each leaf
within 1e-5 of its max |g|), the router's included; three train steps
through `_adam_hold` as ``test_three_train_steps_match_jax`` holds them
(the gradient's 1e-6 of each leaf's largest, 4e-5 orthogonalized). The
routing itself — which expert each assignment goes to, which are dropped —
must be equal: the drop order (a stable sort), the top-k tie order (ties
to the lower expert) and ``moe_groups`` (capacity per group).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.models import moe as jmoe
from repro_torch.models import moe

MOE_ARCHS = ("mixtral-8x22b", "arctic-480b")


# -- the layer ---------------------------------------------------------------


def _layer(jcfg, tcfg, seed=0):
    """JAX's ``init_moe`` parameters and a port `MoE` holding them."""
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    layer = moe.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            w.copy_(torch.from_numpy(np.array(p[name])))
    return p, layer


def _apply_both(jcfg, tcfg, p, layer, x):
    y_j, aux_j = jax.jit(jmoe.apply_moe, static_argnums=2)(
        p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y_t, aux_t = layer(torch.from_numpy(x), tcfg)
    assert y_t.shape == y_j.shape and y_t.dtype == torch.float32
    assert aux_t.dtype == torch.float32 and aux_t.ndim == 0
    # Tolerances: 1e-5 of max |y|, aux 1e-6 relative (float32 rounding).
    assert lp.rel(y_t.numpy(), y_j) < 1e-5
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6 * abs(float(aux_j))
    return y_t


def _x(tcfg, b, t, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, t, tcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_apply_moe_matches_jax(name):
    jcfg, tcfg = lp.cfgs(name)
    p, layer = _layer(jcfg, tcfg)
    _apply_both(jcfg, tcfg, p, layer, _x(tcfg, 2, 24))


def test_forced_drops_match_jax():
    """``capacity_factor=0.25`` over 64 tokens: cap = 8 slots an expert
    against about 32 assignments each, so most drop — in JAX's order (the
    stable sort keeps each expert's earliest tokens)."""
    jcfg, tcfg = lp.cfgs("mixtral-8x22b", {"capacity_factor": 0.25})
    assert moe.capacity(tcfg, 64) == (1, 8)
    p, layer = _layer(jcfg, tcfg, seed=2)
    x = _x(tcfg, 2, 32, seed=3)
    _apply_both(jcfg, tcfg, p, layer, x)
    with torch.no_grad():
        dropped = int(layer.dropped(torch.from_numpy(x), tcfg))
    assert 64 * 2 - 4 * 8 == dropped  # every expert over-subscribed


def test_zero_router_ties_go_to_the_lowest_experts():
    """A zero router: every token's probabilities tie, and ``lax.top_k``
    picks experts 0 and 1 for all of them; so must the port."""
    jcfg, tcfg = lp.cfgs("mixtral-8x22b")
    p, layer = _layer(jcfg, tcfg, seed=4)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    with torch.no_grad():
        layer.router.zero_()
    x = _x(tcfg, 2, 12, seed=5)
    _, _, _, gate_w, gate_e = layer.route(torch.from_numpy(x), tcfg)
    assert (gate_e == torch.tensor([0, 1])).all()
    assert torch.equal(gate_w, torch.full_like(gate_w, 0.5))
    _apply_both(jcfg, tcfg, p, layer, x)


@pytest.mark.parametrize("groups,t", [(2, 24), (4, 24), (5, 13)])
def test_moe_groups_match_jax(groups, t):
    """``moe_groups`` sets where capacity applies: 2 and 4 groups of 2 × 24
    tokens, and 5, which does not divide 2 × 13 (one group, JAX's
    fallback). ``capacity_factor=0.5`` makes drops, so the groups change
    which tokens drop: the output differs from one group's where they
    divide."""
    jcfg, tcfg = lp.cfgs("mixtral-8x22b", {"capacity_factor": 0.5},
                       moe_groups=groups)
    p, layer = _layer(jcfg, tcfg, seed=6)
    x = _x(tcfg, 2, t, seed=7)
    y = _apply_both(jcfg, tcfg, p, layer, x)
    one = dataclasses.replace(tcfg, moe_groups=1)
    with torch.no_grad():
        y1, _ = layer(torch.from_numpy(x), one)
    assert moe.capacity(tcfg, 2 * t)[0] == (groups if 2 * t % groups == 0
                                           else 1)
    assert torch.equal(y, y1) == (2 * t % groups != 0)


# -- the whole model -----------------------------------------------------------

arch = lp.arch_fixture(MOE_ARCHS)


def test_forward_and_aux_match_jax(arch):
    assert lp.forward_and_aux(arch, 24) > 0


def test_loss_gradients_match_jax(arch):
    """Autograd of the port's ``loss_fn`` (its ``aux`` included) against
    ``jax.grad``: every leaf, the router's too, within 1e-5 of its max
    |g|."""
    assert "blocks/pos0/moe/router" in lp.loss_gradients(arch, 24, 1e-5)


@pytest.mark.parametrize("prompt", [17, 5])
def test_prefill_and_decode_match_jax(arch, prompt):
    """Prefill, then 7 teacher-forced decode steps, logits and every cache
    leaf after each call. mixtral's smoke window is 8 slots: a 17-token
    prompt keeps the ring's last 8 rows, a 5-token one is decoded past the
    window, through the ring."""
    lp.prefill_and_decode(arch, prompt, 7)


# -- training ------------------------------------------------------------------


@pytest.mark.parametrize("orthogonal", [False, True])
def test_three_train_steps_match_jax(orthogonal):
    """mixtral-smoke, 3 steps from JAX's state of each step before."""
    lp.three_train_steps("mixtral-8x22b", orthogonal=orthogonal,
                         tau=4e-5 if orthogonal else 1e-6)


def test_driver_trains_and_resumes(tmp_path, capsys):
    lp.driver_resumes("mixtral-8x22b", tmp_path, capsys)
