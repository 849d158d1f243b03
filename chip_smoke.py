#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves on an NVIDIA H100.

  python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card.  It drives
``repro_torch`` only (nothing of JAX or of the JAX package ``repro``):

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA C++ kernels from ``src/repro_torch/csrc`` (compaction,
   split paged decode, and flash prefill by two routes: tensor-core
   ``wgmma`` for bf16 at hd 64/128, CUDA-core otherwise) and holds each
   against its plain PyTorch version on the card, at the serving path's
   shapes, in bf16 and f32 (compaction bit-exact), timing kernel, plain
   version and, where one PyTorch call computes the same function, that
   call, beside the times the previous kernels had;
3. serves full-width smollm_135m (bf16, 30 layers, random weights from the
   seed) from the paged KV pool: 24 requests, 8 slots, max_seq 2048,
   scrambled block tables, compact() after every 8 finished requests, and
   checks that all three kernels ran and that compaction changed no token;
4. serves the f32 model on the card and on the CPU (plain versions) and
   requires the same greedy tokens (phase 3 ends by turning on
   deterministic algorithms and serving its requests again, which must
   give the same token streams: the later phases run in that mode);
5. trains full-width smollm_135m (bf16 params, f32 moments, remat "full",
   batch 4 x 2048 from the port's TokenPipeline) through ``TrainRunner``
   with a 3-controller Raft ``Coordinator`` and a Nezha checkpoint every 4
   steps: 12 steps uninterrupted, then a run that crashes after step 10, a
   restore that must start at 8 and a resumed run whose losses equal the
   uninterrupted run's bit for bit; checks that the training path
   launched none of the kernels (it reaches none in the JAX package
   either), and times a train step, a checkpoint save, restore and GC;
6. takes one f32 train step of smollm_135m at full width and 2 layers on
   the card and on the CPU from the same state and batch, and holds loss,
   gradients and updated params to 1e-4.

Any failure raises.  The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}         # dense, no TF32
FLUSH_BYTES = 64 << 20                                      # > 50 MB of L2
SLEEP_CYCLES = 2_000_000    # ~1 ms of device spin: covers the enqueue
DEVICE = "cuda"
SLOTS, MAX_SEQ = 8, 2048    # the serving phase's slots and context
TRAIN_BATCH, TRAIN_STEPS, CKPT_EVERY, CRASH_AT = 4, 12, 4, 10
# Phase 6: the most of a leaf whose updated values may have an open sign,
# twice the largest share read on the card (embed/embedding 0.0099; every
# other leaf under 0.0009; PERF.md, section 6)
OPEN_SHARE_MAX = 0.02
# The previous paged and flash kernels' times (the CUDA-core flash kernel
# and the unsplit paged kernel) at the same shapes, with the same timer and
# inputs, on one H100 80GB HBM3 at 700 W: copied from PERF.md
# (src/repro_torch/launch/kernel_ab.py measured them) and printed beside the
# new kernels' times, never in the JSON record
PREVIOUS_MS = {"paged_decode_attention": {"bfloat16": 0.17268095940351486,
                                         "float32": 0.287671679854393},
               "flash_attention": {"bfloat16": 0.3309792011976242,
                                   "float32": 0.2774191990494728}}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def timed_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each started with
    a cold L2 (``flush`` overwrites more than the cache between them).  A
    device spin before the start event keeps the card busy while the host
    enqueues ``fn``, so host dispatch stays out of the time."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def _randn(torch, gen, dt, dev, *shape):
    return torch.randn(shape, generator=gen).to(dev, dt)


def _perms(torch, gen, dev, rows, nblk):
    return torch.stack([torch.randperm(nblk, generator=gen)
                        for _ in range(rows)]).to(dev, torch.int32)


def compaction_inputs(torch, cfg, seed, dt, dev):
    """One compact() call's K pool (layers * slots flattened) and tables."""
    gen = torch.Generator().manual_seed(seed)
    nblk = MAX_SEQ // cfg.kv_block_size
    pool = _randn(torch, gen, dt, dev, cfg.n_layers * SLOTS, nblk,
                  cfg.kv_block_size, cfg.n_kv_heads * cfg.hd)
    return pool, _perms(torch, gen, dev, pool.shape[0], nblk)


def paged_inputs(torch, cfg, seed, dt, dev):
    """One layer of one lockstep decode step: ragged lengths, with an empty
    slot and a freed slot one past the pool.  (q, pool_k, pool_v, table,
    length)"""
    gen = torch.Generator().manual_seed(seed + 1)
    nblk = MAX_SEQ // cfg.kv_block_size
    pool = (SLOTS, nblk, cfg.kv_block_size, cfg.n_kv_heads, cfg.hd)
    q = _randn(torch, gen, dt, dev, SLOTS, cfg.n_heads, cfg.hd)
    pk, pv = _randn(torch, gen, dt, dev, *pool), _randn(torch, gen, dt, dev,
                                                        *pool)
    table = _perms(torch, gen, dev, SLOTS, nblk)
    length = torch.randint(1, MAX_SEQ, (SLOTS,), generator=gen)
    length[0], length[1] = 0, MAX_SEQ + 1
    return q, pk, pv, table, length.to(dev, torch.int32)


def flash_inputs(torch, seed, dt, dev, nh, nkv, hd):
    """One layer of one admission padded to MAX_SEQ: (q, k, v)."""
    gen = torch.Generator().manual_seed(seed + 2)
    return (_randn(torch, gen, dt, dev, 1, nh, MAX_SEQ, hd),
            _randn(torch, gen, dt, dev, 1, nkv, MAX_SEQ, hd),
            _randn(torch, gen, dt, dev, 1, nkv, MAX_SEQ, hd))


def flash_shapes(cfg, dt_name):
    """(nh, nkv, hd) timed: smollm_135m's heads, and in bf16 also 32/8 heads
    at hd 128 (the next dense configs' heads) on the same route."""
    return [(cfg.n_heads, cfg.n_kv_heads, cfg.hd)] + (
        [(32, 8, 128)] if dt_name == "bfloat16" else [])


def check_kernels(torch, seed):
    """Phase 2: every kernel against its plain version at the serving
    path's shapes.  Returns {kernel: {dtype: numbers}}."""
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention.ops import WGMMA_ROW_REL, \
        flash_attention, route, row_relative_error
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref, \
        flash_attention_tiled_ref
    from repro_torch.kernels.kv_compaction.ops import compact_kv_pool
    from repro_torch.kernels.kv_compaction.ref import compact_kv_pool_ref
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention, split_plan
    from repro_torch.kernels.paged_attention.ref import \
        paged_decode_attention_ref

    cfg = get("smollm_135m")
    nh, nkv, hd, bs = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.kv_block_size
    nblk = MAX_SEQ // bs
    dev = torch.device(DEVICE)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    res = {"compact_kv_pool": {}, "paged_decode_attention": {},
           "flash_attention": {}}

    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        # kernel and plain version both compute in f32 and round once, so
        # in bf16 they may differ by one rounding: within two bf16 ulps
        tol = dict(rtol=1.6e-2, atol=1e-4) if dt_name == "bfloat16" else \
            dict(rtol=2e-5, atol=2e-5)
        item = torch.tensor([], dtype=dt).element_size()

        pool, table = compaction_inputs(torch, cfg, seed, dt, dev)
        out, _ = compact_kv_pool(pool, table)
        plain = compact_kv_pool_ref(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(out, plain):
            raise AssertionError(f"compact_kv_pool {dt_name}: not bit-exact")
        idx = table.long()[:, :, None, None].expand(pool.shape)
        nbytes = 2 * pool.numel() * item + table.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 0, dt_name)
        res["compact_kv_pool"][dt_name] = dict(
            max_abs_err=0.0, shape=list(pool.shape),
            ms=timed_ms(torch, lambda: compact_kv_pool(pool, table), 20,
                        flush),
            plain_ms=timed_ms(torch, lambda: compact_kv_pool_ref(
                pool, table), 5, flush),
            library_ms=timed_ms(torch, lambda: torch.gather(pool, 1, idx), 20,
                                flush),
            bound_ms=b_ms, bound_by=b_by)
        del pool, plain, out, idx

        q, pk, pv, table, length = paged_inputs(torch, cfg, seed, dt, dev)
        out = paged_decode_attention(q, pk, pv, table, length)
        plain = paged_decode_attention_ref(q, pk, pv, table, length)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), plain.float(), **tol)
        if out[0].abs().max().item() != 0.0:
            raise AssertionError("paged decode at length 0 is not zero")
        again = paged_decode_attention(q, pk, pv, table, length)
        if not torch.equal(again, out):
            raise AssertionError("paged decode: two launches differ")
        bps, nsplit, n_ws = split_plan(SLOTS, nh, nkv, nblk, bs, hd)
        print(f"[kernel] paged_decode_attention {dt_name}: {bps} block(s) "
              f"per split, {nsplit} splits, grid {nsplit * nkv * SLOTS} "
              f"CTAs + merge {nkv * SLOTS} CTAs, workspace {4 * n_ws} "
              f"bytes")
        valid = int(length.clamp(max=nblk * bs).sum())
        nbytes = (2 * valid * nkv * hd * item + 2 * q.numel() * item
                  + 4 * (table.numel() + SLOTS))
        flops = 4 * valid * nh * hd
        b_ms, b_by = bound_ms(nbytes, flops, dt_name)
        res["paged_decode_attention"][dt_name] = dict(
            max_abs_err=(out.float() - plain.float()).abs().max().item(),
            shape=list(pk.shape), lengths=length.tolist(), splits=nsplit,
            workspace_bytes=4 * n_ws,
            ms=timed_ms(torch, lambda: paged_decode_attention(
                q, pk, pv, table, length), 50, flush),
            plain_ms=timed_ms(torch, lambda: paged_decode_attention_ref(
                q, pk, pv, table, length), 10, flush),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        del pk, pv, out, plain, again

        for f_nh, f_nkv, f_hd in flash_shapes(cfg, dt_name):
            q, k, v = flash_inputs(torch, seed, dt, dev, f_nh, f_nkv, f_hd)
            out = flash_attention(q, k, v)
            plain = flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            f_route = route(dt, f_hd)
            if f_route == "wgmma":
                # P rounded to bf16 before P @ V, which flash_attention_ref
                # does not do: each row against that plain version run in
                # f32 (WGMMA_ROW_REL, kernels/flash_attention/ops.py).  The
                # counts show the elementwise limit failing against the
                # plain version in bf16, and against the tiled one, which
                # rounds P too, where a P value lands on the other side of a
                # bf16 rounding boundary than in the kernel
                row_rel = row_relative_error(out, flash_attention_ref(
                    q.float(), k.float(), v.float()))
                tiled = flash_attention_tiled_ref(q, k, v).float()
                off_plain = int((~torch.isclose(out.float(), plain.float(),
                                                **tol)).sum())
                off_tiled = int((~torch.isclose(out.float(), tiled,
                                                **tol)).sum())
                print(f"[kernel] flash_attention {dt_name} hd {f_hd} wgmma: "
                      f"row error {row_rel} of the row's max |plain| "
                      f"against the plain version in f32 (limit "
                      f"{WGMMA_ROW_REL}); elements outside rtol "
                      f"{tol['rtol']} / atol {tol['atol']}: {off_plain} "
                      f"against the plain version in bf16 (max |err| "
                      f"{err}), {off_tiled} against the tiled one (max "
                      f"|err| {(out.float() - tiled).abs().max().item()}), "
                      f"of {out.numel()}")
                del tiled
                if not row_rel <= WGMMA_ROW_REL:
                    raise AssertionError(f"flash {dt_name} hd {f_hd}: row "
                                         f"error {row_rel} > {WGMMA_ROW_REL}")
            else:
                torch.testing.assert_close(out.float(), plain.float(), **tol)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * item
            flops = 4 * f_nh * f_hd * MAX_SEQ * (MAX_SEQ + 1) // 2
            b_ms, b_by = bound_ms(nbytes, flops, dt_name)
            key = dt_name if f_hd == hd else f"{dt_name}_hd{f_hd}"
            res["flash_attention"][key] = dict(
                max_abs_err=err, shape=list(q.shape), route=f_route,
                ms=timed_ms(torch, lambda: flash_attention(q, k, v), 20,
                            flush),
                plain_ms=timed_ms(torch, lambda: flash_attention_ref(q, k, v),
                                  5, flush),
                library_ms=timed_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), 20, flush),
                bound_ms=b_ms, bound_by=b_by)
            del q, k, v, out, plain
    for name, by_dt in res.items():
        for dt_name, r in by_dt.items():
            prev = PREVIOUS_MS.get(name, {}).get(dt_name)
            print(f"[kernel] {name} {dt_name} {r['shape']}"
                  f"{' route ' + r['route'] if 'route' in r else ''}: "
                  f"kernel_ms={r['ms']} plain_ms={r['plain_ms']} "
                  f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} "
                  f"({r['bound_by']}) max_abs_err={r['max_abs_err']}"
                  + (f" [previous kernel: {prev} ms, copied from PERF.md]"
                     if prev else ""))
    return res


def serve_full_width(torch, seed, wrappers):
    """Phase 3: the main path at smollm_135m's published width."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention.ops import route
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.utils import tree_bytes

    cfg = get("smollm_135m")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(16, 513, 24)]

    def run(compact_every):
        eng = ServingEngine(cfg, max_slots=8, max_seq=2048, seed=seed,
                            scramble_blocks=True, device=DEVICE)
        for p in prompts:
            eng.submit(p, max_new=64)
        torch.cuda.synchronize()
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        done = 0
        while eng.active or eng.queue:
            eng.step()
            if compact_every and len(eng.finished) > done and \
                    len(eng.finished) % compact_every == 0:
                frag = eng.fragmentation()
                eng.compact()
                after = eng.fragmentation()
                print(f"[serve] compact() at {len(eng.finished)} finished: "
                      f"fragmentation {frag} -> {after}")
                if after != 0.0:
                    raise AssertionError("fragmentation after compact()")
            done = len(eng.finished)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        return eng, dt, launches

    eng, dt, launches = run(compact_every=8)
    compacted = {r.rid: r.out for r in eng.finished}
    if len(eng.finished) != len(prompts) or any(
            len(r.out) != 65 for r in eng.finished):
        raise AssertionError("not every request finished")
    if eng.compactions != 3:
        raise AssertionError(f"{eng.compactions} compactions, expected 3")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    prefill_route = route(getattr(torch, cfg.param_dtype), cfg.hd)
    if prefill_route != "wgmma":
        raise AssertionError(f"bf16 prefill takes the {prefill_route} route")
    new_tokens = sum(len(r.out) - 1 for r in eng.finished)
    print(f"[serve] params {tree_bytes(eng.params)} bytes, KV cache "
          f"{tree_bytes(eng.caches)} bytes on {eng.device}")
    print(f"[serve] smollm_135m full width bf16: {len(eng.finished)} "
          f"requests, {new_tokens} decoded tokens + {len(prompts)} prefills "
          f"in {dt} s = {(new_tokens + len(prompts)) / dt} tok/s, "
          f"{eng.decode_steps} lockstep steps, launches {launches}, "
          f"prefill route {prefill_route}")
    # a prompt decoded again over the compacted pool gives the same tokens
    first = min(eng.finished, key=lambda r: r.rid)
    again = eng.submit(first.prompt, max_new=64)
    eng.run_until_drained()
    if again.out != first.out:
        raise AssertionError("tokens changed after compaction")
    # and the whole run without any compaction gives the same streams
    plain_eng, _, _ = run(compact_every=0)
    streams = {r.rid: r.out for r in plain_eng.finished}
    if any(streams[r.rid] != r.out for r in eng.finished if r is not again):
        raise AssertionError("compaction changed a token stream")
    print("[serve] tokens equal after compaction and without compaction")
    profile_serving(torch, eng, prompts)
    # the same run under deterministic algorithms, which the later phases
    # keep
    torch.use_deterministic_algorithms(True)
    det_eng, det_dt, _ = run(compact_every=8)
    if {r.rid: r.out for r in det_eng.finished} != compacted:
        raise AssertionError("deterministic algorithms changed a token")
    print(f"[serve] deterministic algorithms: every op of the serving path "
          f"ran, same token streams, {det_dt} s (against {dt} s)")
    return launches, (new_tokens + len(prompts)) / dt


def profile_window(torch, label, fn):
    """Host clock against the device time the profiler sees over ``fn``,
    and the top device consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {label}: wall {wall} ms, device busy {busy} ms "
          f"({100 * busy / wall} %), {sum(e.count for e in kernels)} "
          f"kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3} ms "
              f"x{e.count} {e.key[:90]}")


def profile_serving(torch, eng, prompts):
    """Where a step's time goes: one admission of 8 prompts (8 prefills + a
    decode step) and 8 lockstep decode steps of 8 live slots."""
    for p in prompts[:8]:
        eng.submit(p, max_new=64)
    profile_window(torch, "admit 8 + 1 decode step", eng.step)
    profile_window(torch, "8 decode steps",
                   lambda: [eng.step() for _ in range(8)])
    eng.run_until_drained()


def card_matches_cpu(torch, seed):
    """Phase 4: the f32 full-width engine on the card against the same
    engine on the CPU (plain versions): identical greedy tokens, or a
    near-tie (CPU top-2 logit gap < 1e-4) at the first difference."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import forward, init_params
    from repro_torch.serve.engine import ServingEngine

    cfg = get("smollm_135m").replace(param_dtype="float32")
    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(16, 129, 4)]
    outs = {}
    for dev in (DEVICE, "cpu"):
        eng = ServingEngine(cfg, params, max_slots=4, max_seq=256, seed=seed,
                            device=dev)
        reqs = [eng.submit(p, max_new=8) for p in prompts]
        eng.run_until_drained()
        outs[dev] = [r.out for r in reqs]
    for i, (gpu, cpu) in enumerate(zip(outs[DEVICE], outs["cpu"])):
        if gpu == cpu:
            continue
        step = next(j for j, (a, b) in enumerate(zip(gpu, cpu)) if a != b)
        seq = torch.tensor([prompts[i] + cpu[:step]])
        with torch.no_grad():
            logits, _ = forward(params, seq, cfg, mode="train")
        top2 = torch.topk(logits[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        print(f"[f32] request {i} differs at step {step}: CPU top-2 gap {gap}")
        if gap >= 1e-4:
            raise AssertionError("card and CPU disagree beyond a near-tie")
    print(f"[f32] card and CPU greedy tokens: {outs[DEVICE]} vs "
          f"{outs['cpu']}")


def train_full_width(torch, seed, wrappers):
    """Phase 5: the training path at smollm_135m's published width, with
    the crash -> restore drill, on the card.  Returns the kernels' launch
    counts over the drill."""
    from repro_torch.ckpt.nezha_store import NezhaCheckpointStore
    from repro_torch.configs import ShapeConfig, get
    from repro_torch.core.metrics import Metrics
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import abstract_state
    from repro_torch.runtime.coordinator import Coordinator, TrainRunner
    from repro_torch.utils import tree_bytes, tree_map, tree_paths

    cfg = get("smollm_135m")
    shape = ShapeConfig("chip_smoke", seq_len=MAX_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    print(f"[train] smollm_135m full width: {cfg.param_count()} params "
          f"({cfg.param_dtype}, f32 moments, remat {cfg.remat}), batch "
          f"{TRAIN_BATCH} x {MAX_SEQ}, {TRAIN_STEPS} steps, checkpoint "
          f"every {CKPT_EVERY}, crash after {CRASH_AT}")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    free_before = shutil.disk_usage(root).free
    coords, runners = [], []

    def runner(name, coord):
        runners.append(TrainRunner(cfg, shape, f"{root}/{name}", seed=seed,
                                   ckpt_every=CKPT_EVERY, coordinator=coord,
                                   device=DEVICE))
        return runners[-1]

    try:
        for w in wrappers:
            w.launches = 0
        coords.append(Coordinator(f"{root}/ref", n_controllers=3))
        r1 = runner("ref", coords[0])
        r1.init_or_restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = r1.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ref_metrics = r1.store.metrics
        print(f"[train] uninterrupted: {TRAIN_STEPS} steps in {t_ref} s "
              f"(checkpoints included), losses {ref}, peak device memory "
              f"{peak} bytes; its store wrote {dict(ref_metrics.write_bytes)}"
              f" bytes")
        print(f"[train] Raft commits (uninterrupted run): "
              f"{len(coords[0].committed_steps('step'))} step, "
              f"{len(coords[0].committed_steps('ckpt'))} ckpt, "
              f"{len(coords[0].committed_steps('ckpt_manifest'))} manifest")
        r1.close()
        coords.pop().destroy()
        shutil.rmtree(f"{root}/ref")

        # the control plane outlives the crashed host
        coord = Coordinator(f"{root}/drill", n_controllers=3)
        coords.append(coord)
        r2 = runner("drill", coord)
        r2.init_or_restore()
        failure = None
        t0 = time.perf_counter()
        try:
            r2.run(TRAIN_STEPS, crash_at=CRASH_AT)
        except RuntimeError as e:   # the drill's own injected failure only
            failure = str(e)
        t_crash = time.perf_counter() - t0
        if failure != f"injected host failure at {CRASH_AT}":
            raise AssertionError(f"no injected failure at {CRASH_AT}")
        r2.close()                  # the crashed host's files are closed
        r3 = runner("drill", coord)
        t0 = time.perf_counter()
        start = r3.init_or_restore()
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        expect = CRASH_AT // CKPT_EVERY * CKPT_EVERY
        if start != expect:
            raise AssertionError(f"restored at {start}, expected {expect}")
        t0 = time.perf_counter()
        resumed = r3.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        if resumed != ref[start:]:
            raise AssertionError(f"resumed losses {resumed} differ from "
                                 f"{ref[start:]}")
        launches = {w.__name__: w.launches for w in wrappers}
        if any(launches.values()):
            raise AssertionError(f"the training path launched {launches}")
        print(f"[train] drill: {CRASH_AT} steps then the crash in {t_crash} "
              f"s, restore at {start} in {t_restore} s, "
              f"{TRAIN_STEPS - start} resumed steps in {t_resume} s "
              f"(through the Raft cluster: committed ckpts "
              f"{coord.committed_steps('ckpt')}), resumed losses equal bit "
              f"for bit: {resumed}; kernel launches {launches}")
        print(f"[train] Raft commits (drill, both runs): "
              f"{len(coord.committed_steps('step'))} step, "
              f"{len(coord.committed_steps('ckpt'))} ckpt, "
              f"{len(coord.committed_steps('ckpt_manifest'))} manifest")

        # one train step, timed alone
        pipe = TokenPipeline(cfg, shape, seed=seed, start_step=TRAIN_STEPS)
        try:
            batches = [r3._put_batch(pipe.batch_for_step(TRAIN_STEPS + i))
                       for i in range(3)]
        finally:
            pipe.close()
        # under the deterministic algorithms the drill runs with
        state, times = r3.state, []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = r3.step_fn(state, batches[i])
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        step_s = min(times)
        print(f"[train] step: {[t * 1e3 for t in times]} ms, best "
              f"{step_s * 1e3} ms = {TRAIN_BATCH * MAX_SEQ / step_s} "
              f"tokens/s")
        profile_window(torch, "1 train step",
                       lambda: float(r3.step_fn(state, batches[0])[1]["loss"]))

        # checkpoint save, restore and GC on one store, timed alone
        metrics = Metrics()
        store = NezhaCheckpointStore(f"{root}/bench", metrics,
                                     gc_threshold_bytes=1 << 62)
        nbytes = tree_bytes(state)
        t0 = time.perf_counter()
        store.save(1, tree_map(lambda t: t.detach().cpu(), state))
        t_save = time.perf_counter() - t0
        wa = metrics.write_bytes["ckpt_valuelog"] / nbytes
        if wa != 1.0:
            raise AssertionError(f"checkpoint write amplification {wa}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host, _ = store.restore(abstract_state(cfg), step=1)
        back = tree_map(lambda t: t.to(DEVICE), host)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for (n, a), (_, b) in zip(tree_paths(state), tree_paths(back)):
            if not torch.equal(a, b):
                raise AssertionError(f"restored {n} differs")
        store.save(2, tree_map(lambda t: t.detach().cpu(), state))
        t0 = time.perf_counter()
        store.gc()
        t_gc = time.perf_counter() - t0
        store.close()
        print(f"[ckpt] state {nbytes} bytes; save (device -> host + one "
              f"append) {t_save * 1e3} ms; restore (read + host -> device) "
              f"{t_load * 1e3} ms; GC of {store.keep} checkpoints "
              f"{t_gc * 1e3} ms; ckpt_valuelog {wa} x the state; bytes "
              f"written {dict(metrics.write_bytes)}; read "
              f"{dict(metrics.read_bytes)}")
    finally:
        for r in runners:
            r.close()
        for c in coords:
            c.destroy()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[train] free disk {free_before} bytes before, "
          f"{shutil.disk_usage(tempfile.gettempdir()).free} after")
    return launches


def train_card_matches_cpu(torch, seed):
    """Phase 6: one f32 train step of smollm_135m at full width and 2
    layers, on the card and on the CPU from the same state and batch."""
    from repro_torch.configs import ShapeConfig, get
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_init_fn, make_train_step
    from repro_torch.models import forward, lm_loss
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.utils import tree_leaves, tree_map, tree_paths, \
        tree_unflatten

    cfg = get("smollm_135m").replace(n_layers=2, param_dtype="float32")
    shape = ShapeConfig("chip_smoke_f32", seq_len=512, global_batch=2,
                        kind="train")
    state = make_init_fn(cfg, "cpu")(seed)
    pipe = TokenPipeline(cfg, shape, seed=seed)
    try:
        batch = {k: torch.from_numpy(v)
                 for k, v in pipe.batch_for_step(0).items()}
    finally:
        pipe.close()
    out = {}
    for dev in (DEVICE, "cpu"):
        st = tree_map(lambda t: t.to(dev), state)
        b = {k: v.to(dev) for k, v in batch.items()}
        live = [p.detach().requires_grad_(True)
                for p in tree_leaves(st["params"])]
        logits, _ = forward(tree_unflatten(st["params"], live), b["tokens"],
                            cfg, mode="train")
        grads = torch.autograd.grad(lm_loss(logits, b["labels"]), live)
        new, m = make_train_step(cfg, shape, device=dev)(st, b)
        out[dev] = (float(m["loss"]), [g.cpu() for g in grads],
                    tree_map(lambda t: t.cpu(), new))
    names = [n for n, _ in tree_paths(state["params"])]
    (l_gpu, g_gpu, new_gpu), (l_cpu, g_cpu, new_cpu) = out[DEVICE], out["cpu"]
    if abs(l_gpu - l_cpu) > 1e-4 * abs(l_cpu):
        raise AssertionError(f"f32 loss card {l_gpu} CPU {l_cpu}")
    worst = {}
    for n, a, b in zip(names, g_gpu, g_cpu):
        if not bool(torch.isfinite(a).all()) or float(a.abs().max()) == 0:
            raise AssertionError(f"card gradient of {n} missing or not "
                                 "finite")
        worst[n] = float((a - b).abs().max() / b.abs().max())
        if worst[n] > 1e-4:
            raise AssertionError(f"f32 gradient {n}: {worst[n]}")
    # the train step's moments: m holds (1 - b1) * g and v (1 - b2) * g^2,
    # clip scale included, so they hold the step's own gradients
    cpu_new, gpu_new = dict(tree_paths(new_cpu)), dict(tree_paths(new_gpu))
    moment_err = {}
    for n in names:
        for k in ("m", "v"):
            a, b = gpu_new[f"{k}/{n}"], cpu_new[f"{k}/{n}"]
            moment_err[f"{k}/{n}"] = float((a - b).abs().max()
                                           / b.abs().max())
    # params after one AdamW step, relative to each leaf's largest value;
    # where |m| is within what the card's and the CPU's m differ by, the
    # step's sign is open and only its size is held there
    hyper = OptHyper()
    old = dict(tree_paths(state))
    param_err, open_share = {}, {}
    for n in names:
        a, b, p0 = gpu_new[f"params/{n}"], cpu_new[f"params/{n}"], old[
            f"params/{n}"]
        m_cpu = cpu_new[f"m/{n}"]
        open_sign = m_cpu.abs() <= (gpu_new[f"m/{n}"] - m_cpu).abs().max()
        open_share[n] = float(open_sign.float().mean())
        param_err[n] = float((a - b).abs()[~open_sign].max() / b.abs().max())
        step = (a - p0).abs()[open_sign]
        if bool((step > 1.01 * hyper.lr * (
                1 + hyper.weight_decay * p0.abs()[open_sign])).any()):
            raise AssertionError(f"f32 updated param {n}: step too large")
    print(f"[f32 train] card vs CPU, 2 layers at full width, batch 2 x 512: "
          f"loss {l_gpu} vs {l_cpu}; worst gradient error "
          f"{max(worst.values())} of the leaf's max; every card gradient "
          f"present and finite")
    print(f"[f32 train] moments, error of the leaf's max: {moment_err}")
    print(f"[f32 train] updated params, error of the leaf's max outside the "
          f"open sign: {param_err}")
    print(f"[f32 train] share of each leaf with an open sign: {open_share}")
    for what, errs, limit in (("moment", moment_err, 1e-4),
                              ("updated param", param_err, 1e-4),
                              ("open-sign share of", open_share,
                               OPEN_SHARE_MAX)):
        for n, e in errs.items():
            if e > limit:
                raise AssertionError(f"f32 {what} {n}: {e} > {limit}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # cuBLAS reads this when its first handle is made: set before any CUDA
    # work, so that deterministic algorithms (from the end of phase 3 on)
    # hold for matmuls
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.kv_compaction.ops import compact_kv_pool
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention

    t_start = time.perf_counter()
    print(card_line())
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t0} s")
    for name, lib in built.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    res = check_kernels(torch, args.seed)
    wrappers = (compact_kv_pool, paged_decode_attention, flash_attention)
    launches, tok_s = serve_full_width(torch, args.seed, wrappers)
    card_matches_cpu(torch, args.seed)
    train_launches = train_full_width(torch, args.seed, wrappers)
    train_card_matches_cpu(torch, args.seed)

    from repro_torch.kernels.flash_attention.ops import ROUTES
    kernels = []
    for name, src, replaces in (
            ("compact_kv_pool", "kv_compaction",
             "src/repro/kernels/kv_compaction/kernel.py:27"),
            ("paged_decode_attention", "paged_attention",
             "src/repro/kernels/paged_attention/kernel.py:72"),
            ("flash_attention", None,
             "src/repro/kernels/flash_attention/kernel.py:76")):
        bf, f32 = res[name]["bfloat16"], res[name]["float32"]
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/"
                      f"{src or ROUTES[bf['route']][0]}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "train_launches": train_launches[name],
            "max_abs_err": bf["max_abs_err"],
            "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "dtype": "bfloat16",
            "shape": bf["shape"],
            "float32": {k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}}
        if name == "paged_decode_attention":
            entry["splits"] = bf["splits"]
            entry["workspace_bytes"] = bf["workspace_bytes"]
        if name == "flash_attention":
            # the kernel each (dtype, hd) took, by route; "route" above is
            # the language (CUDA C++) of both
            entry["routes"] = {
                k: {"route": r["route"], "hd": r["shape"][-1],
                    "source": f"src/repro_torch/csrc/"
                              f"{ROUTES[r['route']][0]}.cu",
                    **{f: r[f] for f in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}}
                for k, r in res[name].items()}
        kernels.append(entry)
    print(f"[done] {time.perf_counter() - t_start} s, serving {tok_s} tok/s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
