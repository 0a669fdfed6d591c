"""PyTorch/CUDA port of the tuGEMM serving stack (``repro`` is the JAX
reference it is held against).

The port keeps the reference's sub-package layout: ``configs``, ``core``
(cycle model, PPA), ``kernels`` (hand-written CUDA kernels beside their
plain PyTorch versions), ``quant`` (policies, fused dynamic-quant GEMMs),
``models`` (dense GQA transformer on a paged KV pool) and ``serve`` (the
chunked-prefill paged scheduler). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; asking for ``cuda`` without a card raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA request on a machine without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
