"""Serving launcher: paged-KV continuous batching with Nezha cache GC.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch smollm_135m --requests 8 --max-new 12 --compact-every 4

``--device cpu --smoke`` runs the plain versions of the kernels on the CPU.
``--arch`` takes every architecture of ``repro_torch.configs.ARCH_IDS``; an
embeds-input one (musicgen_medium) is refused, as the engine refuses it.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCH_IDS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--compact-every", type=int, default=0,
                    help="run cache GC every N finished requests")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.serve.engine import ServingEngine, require_token_input

    cfg = get(args.arch, smoke=args.smoke)
    try:
        require_token_input(cfg)
    except ValueError as e:
        ap.error(str(e))
    eng = ServingEngine(cfg, max_slots=args.slots, max_seq=args.max_seq,
                        seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(2, 8))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        eng.submit(prompt, max_new=args.max_new)
    t0 = time.time()
    done = 0
    while eng.active or eng.queue:
        eng.step()
        newly = len(eng.finished) - done
        if newly and args.compact_every and \
                len(eng.finished) % args.compact_every == 0:
            frag = eng.fragmentation()
            eng.compact()
            print(f"[serve] cache GC: fragmentation {frag:.2f} -> "
                  f"{eng.fragmentation():.2f}")
        done = len(eng.finished)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    tokens = sum(len(r.out) for r in eng.finished)
    print(f"[serve] {len(eng.finished)} requests, {tokens} tokens in "
          f"{dt:.1f}s ({tokens / dt:.1f} tok/s) on {eng.device}, "
          f"{eng.decode_steps} decode steps, {eng.compactions} GCs")
    for r in eng.finished[:4]:
        print(f"  req{r.rid}: prompt={r.prompt} -> {r.out[:8]}...")


if __name__ == "__main__":
    main()
