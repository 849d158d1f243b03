"""Time the kernels of several checkouts on one card, in turns.

  python3 src/repro_torch/launch/kernel_ab.py [--seed N] ROOT [ROOT ...]

Each ROOT is the root of a checkout of the port, for example another commit
unpacked with ``git archive`` into the ignored ``build/``; give them in the
order parent, change, change, parent to see the card's drift.  Each runs in
a process of its own, which imports that checkout's ``repro_torch``, builds
its kernels into its own ``build/`` and times its wrappers at
``chip_smoke.py``'s phase-2 shapes, on that script's inputs (same seed) and
with its timer (``timed_ms``, of this checkout).  Prints the card's line and
one JSON object per ROOT.  Run it as a file, not with ``-m``: the package
it imports is the checkout's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]


def time_checkout(root: Path, seed: int) -> dict:
    """Kernel times of the checkout at ``root``, in this process."""
    sys.path[:0] = [str(root / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.kv_compaction.ops import compact_kv_pool
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention

    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = get("smollm_135m")
    dev = torch.device("cuda")
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ms = {}
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        pool, table = cs.compaction_inputs(torch, cfg, seed, dt, dev)
        ms[f"compact_kv_pool {dt_name}"] = cs.timed_ms(
            torch, lambda: compact_kv_pool(pool, table), 20, flush)
        del pool, table
        args = cs.paged_inputs(torch, cfg, seed, dt, dev)
        ms[f"paged_decode_attention {dt_name}"] = cs.timed_ms(
            torch, lambda: paged_decode_attention(*args), 50, flush)
        del args
        for nh, nkv, hd in cs.flash_shapes(cfg, dt_name):
            q, k, v = cs.flash_inputs(torch, seed, dt, dev, nh, nkv, hd)
            ms[f"flash_attention {dt_name} ({nh}/{nkv} heads, hd {hd})"] = \
                cs.timed_ms(torch, lambda: flash_attention(q, k, v), 20,
                            flush)
            del q, k, v
    return {"root": str(root), "ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", type=Path, help="time this checkout here")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(time_checkout(args.one.resolve(), args.seed)))
        return 0
    if not args.roots:
        ap.error("give at least one checkout root")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    print(chip_smoke.card_line())
    for root in args.roots:
        done = subprocess.run(
            [sys.executable, __file__, "--one", str(root.resolve()),
             "--seed", str(args.seed)],
            check=True, stdout=subprocess.PIPE, text=True)
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
