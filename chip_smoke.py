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
   requires the same greedy tokens.

Any failure raises.  The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}         # dense, no TF32
FLUSH_BYTES = 64 << 20                                      # > 50 MB of L2
SLEEP_CYCLES = 2_000_000    # ~1 ms of device spin: covers the enqueue
DEVICE = "cuda"
SLOTS, MAX_SEQ = 8, 2048    # the serving phase's slots and context
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
    return launches, (new_tokens + len(prompts)) / dt


def profile_serving(torch, eng, prompts):
    """Where a step's time goes: host clock against the device time the
    profiler sees, for one admission of 8 prompts (8 prefills + a decode
    step) and for 8 lockstep decode steps of 8 live slots."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(label, fn):
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

    for p in prompts[:8]:
        eng.submit(p, max_new=64)
    window("admit 8 + 1 decode step", eng.step)
    window("8 decode steps", lambda: [eng.step() for _ in range(8)])
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
            "launches": launches[name], "max_abs_err": bf["max_abs_err"],
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
