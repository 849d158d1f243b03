"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one;
the file imports nothing of JAX so that it runs where only PyTorch is
installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5; bf16 rtol 1.6e-2 (two bf16 ulps, since kernel and plain
version both compute in f32 and round once) with atol 1e-4; compaction
bit-exact; greedy tokens identical.  bf16 flash on the wgmma route rounds P
to bf16 before P @ V, which flash_attention_ref does not: each output row is
held to WGMMA_ROW_REL of its largest value in the plain version run in f32
(see kernels/flash_attention/ops.py).

The olmoe_1b_7b engine (MoE, qk-norm) on the card against the CPU.

The training path on the card: a full-width step where every parameter
gets a finite gradient, the wrappers refusing inputs that require grad
(their kernels have no backward), and the crash -> restore drill with
bit-identical losses under deterministic algorithms.
"""
import os
import shutil
import tempfile

import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels.flash_attention.ops import WGMMA_ROW_REL, \
    flash_attention, route, row_relative_error
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.kv_compaction.ops import compact_kv_pool
from repro_torch.kernels.kv_compaction.ref import compact_kv_pool_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention, \
    split_plan
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_attention_ref

pytestmark = pytest.mark.cuda
F32, BF16 = torch.float32, torch.bfloat16
# cuBLAS reads this when its first handle is made, before any test runs:
# the checkpoint drill needs deterministic matmuls
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dt):
    return dict(rtol=1.6e-2, atol=1e-4) if dt == BF16 else \
        dict(rtol=2e-5, atol=2e-5)


def _check_flash(out, q, k, v, causal):
    if route(q.dtype, q.shape[-1]) == "wgmma":
        plain = flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal)
        assert row_relative_error(out, plain) <= WGMMA_ROW_REL
    else:
        torch.testing.assert_close(
            out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
            **_tol(q.dtype))


def _randn(gen, dev, dt, *shape):
    return torch.randn(shape, generator=gen).to(dev, dt)


def _perms(gen, dev, rows, nblk):
    return torch.stack([torch.randperm(nblk, generator=gen)
                        for _ in range(rows)]).to(dev, torch.int32)


@pytest.mark.parametrize("B,nh,nkv,S,hd,dt,causal", [
    (2, 4, 2, 256, 64, F32, True),
    (1, 8, 8, 512, 128, BF16, True),
    (2, 6, 2, 128, 64, BF16, True),
    (1, 2, 1, 384, 64, F32, True),
    (3, 4, 4, 128, 256, F32, True),
    (1, 9, 3, 256, 64, BF16, True),
    (1, 4, 4, 256, 64, F32, False),
    (2, 9, 3, 200, 16, F32, True),      # ragged edge, narrow heads
    (1, 9, 3, 2048, 64, BF16, True),    # the serving prefill shape
    # wgmma route: Sq not a multiple of the 64-row tile, GQA 32/8, hd 128
    (1, 32, 8, 300, 128, BF16, True),
    (2, 9, 3, 200, 64, BF16, True),
    (1, 9, 3, 200, 64, BF16, False),    # non-causal, ragged
    (1, 32, 8, 2048, 128, BF16, True),  # qwen3_8b's heads (rep 4)
    (1, 64, 8, 2048, 128, BF16, True),  # qwen2_72b / chameleon_34b (rep 8)
    (1, 48, 8, 2048, 128, BF16, True),  # dbrx_132b (rep 6)
    # cuda-core route in bf16: hd 16 and 256
    (2, 9, 3, 200, 16, BF16, True),
    (1, 4, 2, 192, 256, BF16, True),
])
def test_flash_kernel_matches_plain(dev, B, nh, nkv, S, hd, dt, causal):
    gen = torch.Generator().manual_seed(S + hd)
    q = _randn(gen, dev, dt, B, nh, S, hd)
    k, v = _randn(gen, dev, dt, B, nkv, S, hd), _randn(gen, dev, dt, B, nkv,
                                                       S, hd)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert torch.isfinite(out).all()
    _check_flash(out, q, k, v, causal)


@pytest.mark.parametrize("B,nh,nkv,nblk,bs,hd,dt", [
    (2, 8, 2, 8, 16, 64, F32),
    (3, 4, 4, 4, 32, 128, BF16),
    (1, 16, 8, 16, 8, 64, BF16),
    (4, 2, 2, 2, 64, 128, F32),
    (8, 9, 3, 32, 64, 64, BF16),        # the serving decode shape
    (8, 9, 3, 32, 64, 64, F32),
    # hd 128 at the heads of qwen3_8b (rep 4), qwen2_72b / chameleon_34b
    # (rep 8) and dbrx_132b (rep 6); f32 at rep 8 needs more than 48 KiB of
    # shared memory
    (8, 32, 8, 64, 64, 128, BF16),
    (8, 64, 8, 64, 64, 128, BF16),
    (8, 48, 8, 64, 64, 128, BF16),
    (8, 64, 8, 64, 64, 128, F32),
])
def test_paged_kernel_matches_plain(dev, B, nh, nkv, nblk, bs, hd, dt):
    gen = torch.Generator().manual_seed(nblk * bs + hd)
    q = _randn(gen, dev, dt, B, nh, hd)
    pk = _randn(gen, dev, dt, B, nblk, bs, nkv, hd)
    pv = _randn(gen, dev, dt, B, nblk, bs, nkv, hd)
    table = _perms(gen, dev, B, nblk)
    length = torch.randint(1, nblk * bs + 1, (B,), generator=gen)
    length[0] = 0                       # empty: zeros
    if B > 1:
        length[1] = nblk * bs + 1       # a freed slot one past the pool
    length = length.to(dev, torch.int32)
    out = paged_decode_attention(q, pk, pv, table, length)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]) == 0
    torch.testing.assert_close(
        out.float(),
        paged_decode_attention_ref(q, pk, pv, table, length).float(),
        **_tol(dt))


@pytest.mark.parametrize("B,nh,nkv,nblk,bs,hd,dt", [
    (2, 9, 3, 5, 16, 64, BF16),         # 2 splits x 3 x 2 = 12 CTAs < 132
    (8, 9, 3, 32, 64, 64, BF16),        # 768 CTAs > 132
    (4, 8, 2, 12, 8, 128, F32),         # 8 blocks per split, ragged split
    (3, 32, 8, 20, 32, 128, BF16),      # 10 splits x 8 x 3 = 240 CTAs
])
def test_paged_kernel_split_boundaries(dev, B, nh, nkv, nblk, bs, hd, dt):
    """Lengths on, just before and just after a split boundary, and a
    whole pool; the result is bit-identical on a second launch and after
    the pools are compacted and the table made the identity."""
    bps, nsplit, _ = split_plan(B, nh, nkv, nblk, bs, hd)
    span = bps * bs
    gen = torch.Generator().manual_seed(nblk * bs + hd + 1)
    q = _randn(gen, dev, dt, B, nh, hd)
    pk = _randn(gen, dev, dt, B, nblk, bs, nkv, hd)
    pv = _randn(gen, dev, dt, B, nblk, bs, nkv, hd)
    table = _perms(gen, dev, B, nblk)
    edges = [span, span + 1, span - 1, nblk * bs, 2 * span + 1, 1, 3 * span,
             nblk * bs - 1]
    length = torch.tensor([min(edges[i % len(edges)], nblk * bs)
                           for i in range(B)], dtype=torch.int32,
                          device=dev)
    out = paged_decode_attention(q, pk, pv, table, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(),
        paged_decode_attention_ref(q, pk, pv, table, length).float(),
        **_tol(dt))
    assert torch.equal(paged_decode_attention(q, pk, pv, table, length), out)
    ck, ident = compact_kv_pool(pk.reshape(B, nblk, bs, -1), table)
    cv, _ = compact_kv_pool(pv.reshape(B, nblk, bs, -1), table)
    after = paged_decode_attention(q, ck.reshape(pk.shape),
                                   cv.reshape(pv.shape), ident, length)
    assert torch.equal(after, out)


@pytest.mark.parametrize("shape,dt", [
    ((240, 32, 64, 192), BF16),         # one compact() at the serving shape
    ((3, 7, 16, 64), F32),
])
def test_compaction_kernel_is_bit_exact(dev, shape, dt):
    gen = torch.Generator().manual_seed(sum(shape))
    pool = _randn(gen, dev, dt, *shape)
    table = _perms(gen, dev, shape[0], shape[1])
    out, ident = compact_kv_pool(pool, table)
    assert torch.equal(out, compact_kv_pool_ref(pool, table))
    again, _ = compact_kv_pool(out, ident)
    assert torch.equal(again, out)


def test_card_engine_matches_cpu_engine(dev):
    """f32 GQA smoke model: the engine on the card (three kernels) and on
    the CPU (plain versions) give the same greedy tokens and layout."""
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine
    cfg = get("smollm_135m", smoke=True).replace(
        param_dtype="float32", kv_block_size=8, n_heads=9, n_kv_heads=3,
        head_dim=16)
    params = init_params(cfg, seed=0, device="cpu")
    runs = []
    for d in (dev, "cpu"):
        eng = ServingEngine(cfg, params, max_slots=3, max_seq=64, seed=0,
                            device=d)
        reqs = [eng.submit(p, max_new=6) for p in
                ([5, 9, 2, 7], [1, 2, 3], [11, 4, 6, 8, 10], [3, 3], [9, 1])]
        eng.run_until_drained()
        frag = eng.fragmentation()
        eng.compact()
        again = eng.submit([5, 9, 2, 7], max_new=6)
        eng.run_until_drained()
        runs.append(([r.out for r in reqs], frag, again.out))
    assert runs[0] == runs[1]


def test_card_moe_engine_matches_cpu_engine(dev):
    """f32 olmoe_1b_7b SMOKE (8 experts, top 2, qk-norm): the engine on the
    card and on the CPU give the same greedy tokens and layout, before and
    after compact()."""
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine
    cfg = get("olmoe_1b_7b", smoke=True).replace(param_dtype="float32",
                                                 kv_block_size=8)
    params = init_params(cfg, seed=0, device="cpu")
    runs = []
    for d in (dev, "cpu"):
        eng = ServingEngine(cfg, params, max_slots=3, max_seq=64, seed=0,
                            device=d)
        reqs = [eng.submit(p, max_new=6) for p in
                ([5, 9, 2, 7], [1, 2, 3], [11, 4, 6, 8, 10], [3, 3], [9, 1])]
        eng.run_until_drained()
        frag = eng.fragmentation()
        eng.compact()
        again = eng.submit([5, 9, 2, 7], max_new=6)
        eng.run_until_drained()
        runs.append(([r.out for r in reqs], frag, again.out))
    assert runs[0] == runs[1]


def test_wrappers_refuse_inputs_that_require_grad(dev):
    """The kernels have no backward: a call that would record a graph
    through them raises instead of dropping the gradient, and the same call
    under no_grad (as serving makes it) runs."""
    gen = torch.Generator().manual_seed(9)
    q = _randn(gen, dev, BF16, 1, 9, 128, 64)
    k, v = _randn(gen, dev, BF16, 1, 3, 128, 64), _randn(gen, dev, BF16, 1,
                                                        3, 128, 64)
    pk, pv = (_randn(gen, dev, F32, 2, 4, 16, 3, 64) for _ in range(2))
    qd = _randn(gen, dev, F32, 2, 9, 64)
    table = _perms(gen, dev, 2, 4)
    length = torch.tensor([20, 64], dtype=torch.int32, device=dev)
    pool = _randn(gen, dev, F32, 2, 4, 16, 192)
    calls = {
        "flash_attention": (lambda a: flash_attention(a[0], a[1], a[2]),
                            [q, k, v]),
        "paged_decode_attention": (lambda a: paged_decode_attention(
            a[0], a[1], a[2], table, length), [qd, pk, pv]),
        "compact_kv_pool": (lambda a: compact_kv_pool(a[0], table), [pool]),
    }
    for name, (call, args) in calls.items():
        for i in range(len(args)):
            live = [a.detach().requires_grad_(j == i)
                    for j, a in enumerate(args)]
            with pytest.raises(RuntimeError, match="no backward"):
                call(live)
            with torch.no_grad():
                call(live)
        call(args)


def test_full_width_train_step_gives_every_parameter_a_gradient(dev):
    """smollm_135m as published (bf16, remat "full") at batch 2 x 512: one
    backward pass reaches every parameter, the attention projections
    included, with finite values, and the train step runs."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import make_init_fn, make_train_step
    from repro_torch.models import forward, lm_loss
    from repro_torch.utils import tree_leaves, tree_paths, tree_unflatten
    cfg = get("smollm_135m")
    state = make_init_fn(cfg, dev)(0)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen).to(dev)
    labels = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen).to(dev)
    live = [p.detach().requires_grad_(True)
            for p in tree_leaves(state["params"])]
    logits, _ = forward(tree_unflatten(state["params"], live), tokens, cfg,
                        mode="train")
    grads = torch.autograd.grad(lm_loss(logits, labels), live)
    names = [n for n, _ in tree_paths(state["params"])]
    assert {"layers/0/attn/wq", "layers/0/attn/wk", "layers/0/attn/wv"} <= \
        set(names)
    for n, g in zip(names, grads):
        assert g is not None and g.dtype == BF16, n
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, n
    step = make_train_step(cfg, ShapeConfig("t", 512, 2, "train"), device=dev)
    new, m = step(state, {"tokens": tokens, "labels": labels})
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert int(new["step"]) == 1


def test_crash_restore_drill_on_the_card(dev):
    """The drill of tests/test_torch_ckpt.py on the card: crash after step
    10, restore at 8 through the coordinator, bit-identical losses."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime.coordinator import Coordinator, TrainRunner
    cfg = get("smollm_135m", smoke=True)
    shape = ShapeConfig("t", seq_len=64, global_batch=4, kind="train")
    wd = tempfile.mkdtemp()
    torch.use_deterministic_algorithms(True)
    coords = [Coordinator(f"{wd}/ref"), Coordinator(f"{wd}/drill")]
    runners = []

    def runner(name, coord):
        runners.append(TrainRunner(cfg, shape, f"{wd}/{name}", seed=7,
                                   ckpt_every=4, coordinator=coord,
                                   device=dev))
        return runners[-1]

    try:
        r = runner("ref", coords[0])
        r.init_or_restore()
        ref = r.run(12)
        r2 = runner("drill", coords[1])
        r2.init_or_restore()
        with pytest.raises(RuntimeError, match="injected host failure"):
            r2.run(12, crash_at=10)
        r2.close()
        r3 = runner("drill", coords[1])
        assert r3.init_or_restore() == 8
        assert r3.state["params"]["embed"]["embedding"].device.type == \
            dev.type
        assert r3.run(12) == ref[8:]
    finally:
        torch.use_deterministic_algorithms(False)
        for x in runners:
            x.close()
        for c in coords:
            c.destroy()
        shutil.rmtree(wd, ignore_errors=True)
