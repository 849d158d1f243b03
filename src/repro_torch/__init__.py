"""PyTorch/CUDA port of the paged-KV serving path of ``repro``.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor JAX) and keeps its own copies of the configs and tree helpers it
needs.  Every entry point takes ``device=`` and defaults to ``"cuda"``: on a
machine without a card the default raises instead of running on the CPU.
"""
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev
