"""Shared pieces of the ctypes kernel wrappers: dtype codes, argument checks,
launch counters and the launch-error check."""

from __future__ import annotations

import torch

__all__ = ["DTYPE_CODE", "KernelCount", "check", "ptr", "stream_ptr", "raise_on", "sm_count",
           "IMPLS", "meta_route", "charge_meta"]

# ``impl`` values of the kernel wrappers. ``auto`` on a meta tensor returns
# empty outputs of the right shapes and charges the kernel's count to the
# active ``roofline.op_cost.OpCost``: the tensor alone decides that path
IMPLS = ("auto", "torch", "cuda")

# dtype codes of the C launchers (csrc/*.cu)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

class KernelCount:
    """Launch counter beside a kernel: ``launches`` counts the kernel's own
    launches (the wrapper adds one where it launches and nowhere else),
    ``plain_calls`` the calls that ran the plain PyTorch version instead."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    def as_dict(self) -> dict:
        return {"launches": self.launches, "plain_calls": self.plain_calls}


def meta_route(impl: str, t: torch.Tensor) -> bool:
    """Whether a call with ``impl`` on ``t`` takes the meta path: ``auto``
    on a meta tensor (raises on an unknown ``impl``). A meta tensor under
    ``cuda`` does not: the kernel path then raises, as on any non-CUDA
    tensor."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "auto" and t.device.type == "meta"


def charge_meta(count: "KernelCount", cost: tuple, shape=()) -> None:
    """Charge one meta call of ``count``'s kernel at ``cost`` = (bytes,
    operations) (``roofline.kernel_cost``); no launch, no plain call."""
    from ..roofline.kernel_cost import charge

    charge(count.name, *cost, shape=tuple(shape))


def check(cond: bool, msg) -> None:
    """Raise ValueError(msg) unless cond; ``msg`` may be a zero-argument
    callable, so a hot wrapper formats its message only when it raises."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_sms: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The device's SM count (read once per device), for the split plans."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def raise_on(rc: int, name: str) -> None:
    """Raise if a C launcher reported an error (it returns the
    cudaGetLastError of its launch, -1 for an unsupported dtype, -2 for a tile
    or split plan the kernel does not take)."""
    if rc == -1:
        raise ValueError(f"{name}: unsupported dtype combination")
    if rc == -2:
        raise ValueError(f"{name}: the tile or split plan does not fit the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError_t {rc})")
