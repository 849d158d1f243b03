"""The port's ServingEngine against the JAX package's, on the CPU.

Each scenario of tests/test_serving.py is replayed on both engines with the
same JAX-built params and the same seed: the greedy token streams and the
``fragmentation()`` readings must be identical.  smollm_135m throughout, and
qwen3_8b and olmoe_1b_7b at SMOKE width once each.  The port runs with
``device="cpu"``, i.e. the plain versions of its kernels.
"""
import jax
import numpy as np
import pytest

from repro.configs import get as jax_get
from repro.models import init_params as jax_init_params
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy
from repro_torch.serve.engine import ServingEngine
from repro_torch.utils import tree_paths

CFG = get("smollm_135m", smoke=True).replace(param_dtype="float32",
                                             kv_block_size=8)
GQA = CFG.replace(n_heads=9, n_kv_heads=3, head_dim=16)


def _jax_cfg(cfg):
    return jax_get("smollm_135m", smoke=True).replace(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def engines():
    """make(cfg, **kw) -> (jax_engine, port_engine) over the same params."""
    cache = {}

    def make(cfg=CFG, **kw):
        if cfg not in cache:
            p = jax_init_params(jax.random.PRNGKey(0), _jax_cfg(cfg))
            cache[cfg] = (p, params_from_numpy(jax.tree.map(np.asarray, p),
                                               device="cpu"))
            assert cache[cfg][1]["embed"]["embedding"].device.type == "cpu"
        jp, tp = cache[cfg]
        return (JaxEngine(_jax_cfg(cfg), jp, scramble_blocks=True, **kw),
                ServingEngine(cfg, tp, scramble_blocks=True, device="cpu",
                              **kw))
    return make


def _streams(eng):
    return {r.rid: r.out for r in eng.finished}


def _same(jeng, teng):
    assert _streams(teng) == _streams(jeng)
    assert teng.fragmentation() == jeng.fragmentation()


@pytest.mark.parametrize("cfg", [CFG, GQA], ids=["smoke", "gqa"])
def test_continuous_batching_matches_jax_engine(engines, cfg):
    jeng, teng = engines(cfg, max_slots=3, max_seq=64, seed=0)
    prompts = [[5, 9, 2, 7], [1, 2, 3], [11, 4, 6, 8, 10], [3, 3, 3], [9, 1]]
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new=6)
    assert teng.run_until_drained() == jeng.run_until_drained()
    assert len(teng.finished) == len(prompts)
    assert teng.decode_steps == jeng.decode_steps
    _same(jeng, teng)


def test_fragmentation_and_compaction_match_jax_engine(engines):
    jeng, teng = engines(max_slots=2, max_seq=64, seed=1)
    for eng in (jeng, teng):
        for i in range(4):
            eng.submit([1 + i, 2, 3], max_new=4)
        eng.run_until_drained()
    assert teng.fragmentation() > 0.3
    _same(jeng, teng)
    jeng.compact(backend="reference")
    teng.compact()
    assert teng.fragmentation() == 0.0
    for eng in (jeng, teng):
        eng.submit([5, 9, 2, 7], max_new=5)
        eng.run_until_drained()
    _same(jeng, teng)


def test_compaction_matches_jax_pallas_interpret_kernel(engines):
    jeng, teng = engines(max_slots=2, max_seq=32, seed=2)
    for eng in (jeng, teng):
        eng.submit([4, 2], max_new=3)
        eng.run_until_drained()
    jeng.compact(backend="pallas_interpret")
    teng.compact()
    _same(jeng, teng)
    for eng in (jeng, teng):
        eng.submit([4, 2], max_new=3)
        eng.run_until_drained()
    _same(jeng, teng)


def test_mid_stream_admission_matches_jax_engine(engines):
    jeng, teng = engines(max_slots=2, max_seq=64, seed=3)
    for eng in (jeng, teng):
        eng.submit([7, 7, 7], max_new=8)
        for _ in range(3):
            eng.step()
        eng.submit([1, 2, 3, 4], max_new=4)
        eng.run_until_drained()
    _same(jeng, teng)


def test_free_slot_at_max_seq_matches_jax_engine(engines):
    """A request with plen + max_new == max_seq leaves its freed slot at
    pos == max_seq, one past the pool; lockstep decode keeps stepping that
    slot.  Its write is dropped (as JAX drops it), the live slot's tokens
    are untouched, and the slot serves the next request."""
    jeng, teng = engines(GQA, max_slots=2, max_seq=32, seed=4)
    for eng in (jeng, teng):
        r1 = eng.submit([1, 2, 3, 4], max_new=28)
        for _ in range(20):
            eng.step()
        eng.submit([5, 6, 7], max_new=10)
        while not r1.done:
            eng.step()
        eng.step()
        eng.step()
        assert eng.pos[r1.slot] == eng.max_seq and r1.slot in eng.free_slots
        eng.submit([9, 9], max_new=4)
        eng.run_until_drained()
    assert len(teng.finished) == 3
    _same(jeng, teng)


def _arch(arch):
    """(port cfg, JAX cfg, JAX params, torch params) of ``arch``'s f32
    SMOKE config with KV blocks of 8."""
    kw = dict(param_dtype="float32", kv_block_size=8)
    jcfg = jax_get(arch, smoke=True).replace(**kw)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return (get(arch, smoke=True).replace(**kw), jcfg, jp,
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen3_8b"])
def test_serving_engine_matches_jax_engine(arch):
    """The qk-norm GQA config and the MoE config at SMOKE width:
    continuous batching, fragmentation, compaction and the tables after
    it, then a request served from the compacted pool."""
    cfg, jcfg, jp, tp = _arch(arch)
    jeng = JaxEngine(jcfg, jp, max_slots=2, max_seq=64, seed=1)
    teng = ServingEngine(cfg, tp, max_slots=2, max_seq=64, seed=1,
                         device="cpu")
    for eng in (jeng, teng):
        for p in ([5, 9, 2, 7], [1, 2, 3], [11, 4, 6, 8, 10], [3, 3]):
            eng.submit(p, max_new=5)
        eng.run_until_drained()
    assert {r.rid: r.out for r in teng.finished} == \
        {r.rid: r.out for r in jeng.finished}
    assert teng.fragmentation() == jeng.fragmentation() > 0.3
    jeng.compact(backend="reference")
    teng.compact()
    assert teng.fragmentation() == jeng.fragmentation() == 0.0
    for (n, a), (_, b) in zip(tree_paths(teng.caches),
                              tree_paths(jeng.caches)):
        if n.endswith("table"):
            assert np.array_equal(a.numpy(), np.asarray(b)), n
    for eng in (jeng, teng):
        eng.submit([5, 9, 2, 7], max_new=5)
        eng.run_until_drained()
    assert {r.rid: r.out for r in teng.finished} == \
        {r.rid: r.out for r in jeng.finished}


def test_engine_refuses_embeds_input_as_the_jax_engine_fails():
    """musicgen_medium takes (B, S, d) embeds: the port's submit raises;
    the JAX engine takes the request and fails at its prefill."""
    cfg, jcfg, jp, tp = _arch("musicgen_medium")
    eng = ServingEngine(cfg, tp, max_slots=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="embeds"):
        eng.submit([1, 2, 3], max_new=4)
    jeng = JaxEngine(jcfg, jp, max_slots=2, max_seq=32)
    jeng.submit([1, 2, 3], max_new=4)
    with pytest.raises(ValueError):
        jeng.step()
