"""PyTorch/CUDA port of the FlashAttention serving system (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (core/, kernels/, configs/, models/, serve/, telemetry/, launch/)
and imports neither ``jax`` nor anything of ``repro``. Every TPU kernel on
the ported path is a hand-written CUDA kernel for Hopper (sm_90a) with a
plain PyTorch version beside it; entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a usable card
    raises: the card path never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
