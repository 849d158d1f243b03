"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
      --arch smollm_135m --steps 50 --batch 8 --seq 64 --ckpt-every 10 \\
      --workdir runs/train1 --coordinator

Resumable: re-launching with the same --workdir restores the last committed
Nezha checkpoint manifest and continues bit-identically (restart-safe data
pipeline; on CUDA the launcher turns on deterministic algorithms).
--crash-at simulates a host failure for drills.  ``--device cpu --smoke``
runs a reduced config on the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                    "repro_torch_train"))
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--coordinator", action="store_true",
                    help="run the Raft control plane (step/ckpt commits)")
    args = ap.parse_args()

    # cuBLAS reads this when its first handle is made: set it before any
    # CUDA work, so that deterministic algorithms hold for matmuls too
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.configs import ShapeConfig, get
    from repro_torch.runtime.coordinator import Coordinator, TrainRunner

    torch.use_deterministic_algorithms(True)
    cfg = get(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    coord = Coordinator(args.workdir) if args.coordinator else None
    runner = TrainRunner(cfg, shape, args.workdir, seed=args.seed,
                         ckpt_every=args.ckpt_every, coordinator=coord,
                         device=args.device)
    try:
        start = runner.init_or_restore()
        print(f"[train] {cfg.name} starting at step {start} on "
              f"{runner.device} (params={cfg.param_count() / 1e6:.1f}M)")
        t0 = time.time()
        losses = runner.run(args.steps, crash_at=args.crash_at)
        dt = time.time() - t0
    finally:
        runner.close()
    done = len(losses)
    if done:
        print(f"[train] {done} steps in {dt:.1f}s "
              f"({done * args.batch * args.seq / dt:.0f} tok/s) "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if coord is not None:
        print(f"[train] committed ckpts: {coord.committed_steps('ckpt')}")
        coord.destroy()


if __name__ == "__main__":
    main()
