"""The port's MoE FFN against the JAX package's, on the CPU.

``_route``, the dense no-drop path, the capacity-bounded local path and
``moe_apply``'s choice between them, at the SMOKE widths of olmoe_1b_7b
(8 experts, top 2) and dbrx_132b (4 experts, top 2) in float32.  Params are
one layer of JAX ``init_params``; inputs come from numpy with a seed.
Tolerances: f32 2e-5 (tests/test_kernels.py); top-k indices exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _moe_case(arch="olmoe_1b_7b", T=64, seed=5, **kw):
    kw = dict(param_dtype="float32", **kw)
    cfg = get(arch, smoke=True).replace(**kw)
    jcfg = jax_get(arch, smoke=True).replace(**kw)
    jp = jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(seed), jcfg)["layers"][0])
    jp = jax.tree.map(lambda a: a[0], jp["moe"])
    x = np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, params_from_numpy(jp, device="cpu"), x


def test_route_matches_jax_top_k_exactly():
    """Indices equal exactly, ties included: with duplicated router
    columns every token has tied experts, and jax.lax.top_k puts the lower
    index first."""
    cfg, _, jp, tp, x = _moe_case()
    router = jp["router"].copy()
    router[:, 1::2] = router[:, 0::2]        # expert 2i+1 ties with 2i
    for w in (jp["router"], router):
        jv, ji, jprobs = jax_moe._route(jnp.asarray(x), jnp.asarray(w),
                                        cfg.top_k)
        tv, ti, probs = moe._route(torch.from_numpy(x), torch.tensor(w),
                                   cfg.top_k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), _np(jv), **F32_TOL)
        np.testing.assert_allclose(probs.numpy(), _np(jprobs), **F32_TOL)
    assert (ti[:, 0] % 2 == 0).all()         # the tie went to the lower one


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "dbrx_132b"])
def test_moe_dense_nodrop_matches_jax(arch):
    cfg, jcfg, jp, tp, x = _moe_case(arch)
    ref = jax_moe._moe_dense_nodrop(jnp.asarray(x), jax.tree.map(
        jnp.asarray, jp), jcfg)
    out = moe._moe_dense_nodrop(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32_TOL)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_local_matches_jax(capacity_factor):
    """The capacity-bounded path; at capacity factor 0.5 some (token,
    choice) pairs are dropped, and the output then differs from the
    no-drop path's."""
    cfg, jcfg, jp, tp, x = _moe_case(capacity_factor=capacity_factor)
    args = (jp["router"], jp["experts_wi"], jp["experts_wg"],
            jp["experts_wo"])
    ref = jax_moe._moe_local(jnp.asarray(x), *map(jnp.asarray, args),
                             cfg=jcfg, E_local=cfg.n_experts,
                             model_axis=None)
    out = moe._moe_local(torch.from_numpy(x), *map(torch.tensor, args),
                         cfg=cfg, E_local=cfg.n_experts)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32_TOL)
    nodrop = moe._moe_dense_nodrop(torch.from_numpy(x), tp, cfg)
    dropped = not np.allclose(out.numpy(), nodrop.numpy(), **F32_TOL)
    assert dropped == (capacity_factor < 1)


def test_moe_apply_above_4096_tokens_takes_the_local_path():
    """B * S = 2 * 2056 > 4096: moe_apply is _moe_local on both sides
    (capacity factor 0.5, so it differs from the no-drop path)."""
    cfg, jcfg, jp, tp, _ = _moe_case(T=1, capacity_factor=0.5)
    x = np.random.default_rng(6).standard_normal(
        (2, 2056, cfg.d_model)).astype(np.float32)
    ref = jax_moe.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jcfg, None)
    out = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32_TOL)
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    local = moe._moe_local(xt, tp["router"], tp["experts_wi"],
                           tp["experts_wg"], tp["experts_wo"], cfg=cfg,
                           E_local=cfg.n_experts)
    assert torch.equal(out.reshape(-1, cfg.d_model), local)
    assert not torch.allclose(local, moe._moe_dense_nodrop(xt, tp, cfg),
                              **F32_TOL)
    jax_local = jax_moe._moe_local(
        jnp.asarray(xt.numpy()), *(jnp.asarray(jp[k]) for k in (
            "router", "experts_wi", "experts_wg", "experts_wo")),
        cfg=jcfg, E_local=cfg.n_experts, model_axis=None)
    assert np.array_equal(np.asarray(ref).reshape(-1, cfg.d_model),
                          np.asarray(jax_local))
