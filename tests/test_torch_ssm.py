"""The port's state-space mixers (Mamba, the RWKV-6 time and channel mix)
and the configs that use them (rwkv6-1.6b, jamba-v0.1-52b) against the JAX
package's, on the CPU.

The same weights (JAX's ``init_mamba`` / ``init_rwkv`` /
``init_rwkv_cmix`` / ``init_params``, carried across as numpy) and the same
inputs (numpy, seeded) go through JAX's functions and the port's. JAX runs
as the suite runs it (x64 on, CPU). Float32 compute, at the smoke configs.
The layers run with ``ssm_chunk=8``: T = 20 is padded to 3 chunks, T = 24
is 3 whole ones; with and without a carried state. Tolerances: a layer's
output and new state within 1e-5 of their max |value|; logits, prefill
and decode within `tests/test_torch_lm.py`'s 1e-4 of max |logits|, caches
leaf by leaf at the same bound; gradients within 1e-5 of each leaf's max
|g| (``tests/test_torch_train.py``'s bound) for jamba, and 1e-4 for
rwkv6 — its float32 gradient is this far from a float64 one in JAX itself:
on these weights JAX's float32 gradient differs from the port's float64
one (every float32 cast of the model widened) by up to 5.9e-5 of a leaf's
max |g| (``blocks/pos0/mixer/mix_w1`` at T = 24; 3.5e-5 at T = 100),
the port's by up to 1.2e-4, and the two by 5.8e-5 and 4.7e-5: the
per-head group norm of a 8-wide head rescales small early outputs. Three
train steps through `_adam_hold` carry that gradient tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.models import ssm
from repro_torch.models.weights import params_from_jax

SSM_ARCHS = ("rwkv6-1.6b", "jamba-v0.1-52b")
GRAD_TOL = {"rwkv6-1.6b": 1e-4, "jamba-v0.1-52b": 1e-5}


# -- the layers ------------------------------------------------------------------

# name -> (config, JAX init, JAX apply, port module, JAX's empty cache)
LAYERS = {
    "mamba": ("jamba-v0.1-52b", jssm.init_mamba, jssm.apply_mamba, ssm.Mamba,
              jssm.init_mamba_cache),
    "rwkv": ("rwkv6-1.6b", jssm.init_rwkv, jssm.apply_rwkv, ssm.RWKV,
             jssm.init_rwkv_cache),
    "cmix": ("rwkv6-1.6b", jssm.init_rwkv_cmix, jssm.apply_rwkv_cmix,
             ssm.RWKVCMix, None),
}


def _random_cache(jcache_fn, jcfg, b, rng):
    """A carried state of the layer's shapes and dtypes, random."""
    if jcache_fn is None:
        empty = {"shift": np.zeros((b, 1, jcfg.d_model), np.float32)}
    else:
        empty = jax.tree_util.tree_map(np.asarray, jcache_fn(jcfg, b))
    return {k: rng.normal(size=v.shape).astype(v.dtype) * 0.5
            for k, v in empty.items()}


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("t", [20, 24])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_jax(layer, t, carried):
    name, jinit, japply, cls, jcache = LAYERS[layer]
    jcfg, tcfg = lp.cfgs(name, ssm_chunk=8)
    p = jinit(jax.random.PRNGKey(3), jcfg)
    mod = cls(tcfg, device="cpu")
    with torch.no_grad():
        for pname, w in mod.named_parameters():
            w.copy_(torch.from_numpy(np.array(p[pname])))
    rng = np.random.default_rng(t + carried)
    x = rng.normal(size=(2, t, tcfg.d_model)).astype(np.float32)
    cache = _random_cache(jcache, jcfg, 2, rng) if carried else None
    y_j, c_j = jax.jit(japply, static_argnums=2)(
        p, jnp.asarray(x), jcfg,
        None if cache is None else {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    with torch.no_grad():
        y_t, c_t = mod(torch.from_numpy(x), tcfg, cache=tc)
    if carried:
        assert c_t is tc  # written in place
    assert y_t.shape == y_j.shape and y_t.dtype == torch.float32
    assert lp.rel(y_t.numpy(), y_j) < 1e-5
    assert set(c_t) == set(c_j)
    for k, leaf in c_j.items():
        assert c_t[k].shape == leaf.shape and c_t[k].dtype == getattr(
            torch, np.asarray(leaf).dtype.name), k
        assert lp.rel(c_t[k].numpy(), leaf) < 1e-5, k


def test_assoc_scan_takes_jax_order():
    """`_assoc_inclusive` is JAX's jitted ``_assoc_inclusive``: the states
    of h_t = d_t·h_{t-1} + u_t bit for bit over 13 and 16 steps (the odd
    and even branches of the recursion), with a decay broadcast over the
    state's last axis as RWKV's (XLA fuses the multiply-add, and so does
    ``addcmul``)."""
    rng = np.random.default_rng(8)
    for t in (13, 16):
        d = rng.uniform(0.5, 1.0, (2, t, 3, 1)).astype(np.float32)
        u = rng.normal(size=(2, t, 3, 4)).astype(np.float32)
        dd_j, uu_j = jax.jit(jssm._assoc_inclusive)(jnp.asarray(d),
                                                    jnp.asarray(u))
        dd_t, uu_t = ssm._assoc_inclusive(torch.from_numpy(d),
                                          torch.from_numpy(u))
        np.testing.assert_array_equal(dd_t.numpy(), np.asarray(dd_j))
        np.testing.assert_array_equal(uu_t.numpy(), np.asarray(uu_j))


# -- the whole model -------------------------------------------------------------

arch = lp.arch_fixture(SSM_ARCHS)


def test_forward_and_aux_match_jax(arch):
    """Logits over 100 tokens (two chunks of 64, the second padded);
    jamba's MoE positions add aux, rwkv6 has none."""
    lp.forward_and_aux(arch, 100)


def test_loss_gradients_match_jax(arch):
    """Autograd of the port's ``loss_fn`` (each chunk checkpointed) against
    ``jax.grad`` at 100 tokens, each leaf within `GRAD_TOL` of its max |g|
    (see the module's docstring)."""
    lp.loss_gradients(arch, 100, GRAD_TOL[arch["name"]])


@pytest.mark.parametrize("prompt", [17, 5])
def test_prefill_and_decode_match_jax(arch, prompt):
    """Prefill, then 6 teacher-forced decode steps: logits and every cache
    leaf (attention, mamba's conv and ssm states, rwkv's shift and state,
    the channel mix's shift) after each call."""
    lp.prefill_and_decode(arch, prompt, 6)


def test_init_cache_matches_jax(arch):
    jcfg, tcfg = lp.cfgs(arch["name"], compute_dtype="bfloat16")
    got = params_from_jax(arch["tree"], tcfg, device="cpu").init_cache(3, 16)
    want = lp.np_tree(jtf.init_cache(jcfg, 3, 16))
    assert set(got) == set(want)
    for j, sub in want.items():
        assert set(got[j]) == set(sub)
        for kind, leaves in sub.items():
            for name, leaf in leaves.items():
                mine = got[j][kind][name]
                assert mine.dtype == {"pos": torch.int32,
                                      "ssm": torch.float32,
                                      "state": torch.float32}.get(
                    name, torch.bfloat16), (j, kind, name)
                np.testing.assert_array_equal(mine.float().numpy(), leaf)


# -- training --------------------------------------------------------------------


def test_three_train_steps_match_jax():
    """rwkv6-smoke, 3 steps from JAX's state of each step before, with
    rwkv6's gradient tolerance (1e-4 of each leaf's largest) carried
    through Adam."""
    lp.three_train_steps("rwkv6-1.6b", orthogonal=False,
                         tau=GRAD_TOL["rwkv6-1.6b"])


def test_driver_trains_and_resumes(tmp_path, capsys):
    lp.driver_resumes("rwkv6-1.6b", tmp_path, capsys)
