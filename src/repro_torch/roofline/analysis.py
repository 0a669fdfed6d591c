"""Three-term roofline from counted costs (the reference's
``repro/roofline/analysis.py``; no hardware needed).

    compute term    = FLOPs / peak FLOP/s              (per chip)
    memory term     = HBM bytes / HBM rate             (per chip)
    collective term = collective bytes / link rate     (per chip)

The reference reads its counts from a compiled XLA module's text. The port
has no compiler to ask: the counts come from running the step on ``meta``
tensors under ``roofline.op_cost.count_ops`` (an :class:`~repro_torch.roofline.op_cost.OpCost`),
and :func:`analyze` prices them. The formulas of the three terms,
``dominant``, ``bound_s``, ``useful_ratio`` and ``mfu`` are the reference's.

Collectives are charged by the reference's table (``hlo_parse._COLLECTIVES``):

    all-reduce         2 x result bytes    (ring reduce-scatter + all-gather)
    all-gather         1 x result bytes    (each chip receives the full result)
    reduce-scatter     1 x operand bytes   (sends its full input once around)
    all-to-all         1 x result bytes
    collective-permute 1 x result bytes

That is the roofline's price of a call, not the bytes a rank receives:
``parallel.collectives.ring_bytes`` counts those (an all-reduce
``2(n-1)/n`` of the operand), for the training mesh's wire meter. Both are
kept; this table prices the collective term.

:data:`HW_PROFILES` keeps the reference's ``tpu``, ``gpu`` and ``cpu``
profiles with their numbers and adds ``h100``, the port's target, whose
int8 and f32 rates also bound the kernels (``roofline.kernel_cost``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "HW", "HW_PROFILES", "hw_profile", "COLLECTIVE_PRICE", "collective_charge",
    "CollectiveStats", "RooflineReport", "analyze",
]


@dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12      # bf16 FLOP/s per chip
    hbm_bw: float = 819e9           # bytes/s per chip
    ici_bw: float = 50e9            # bytes/s per link
    hbm_per_chip: float = 16e9      # bytes per chip
    name: str = "tpu"
    int8_ops: float | None = None   # int8 OP/s per chip (None: peak_flops)
    f32_flops: float | None = None  # f32 FLOP/s per chip (None: peak_flops)

    def rate(self, kind: str = "bf16") -> float:
        """The peak rate of ``kind`` operations: ``bf16``, ``int8`` or ``f32``."""
        if kind == "int8":
            return self.int8_ops or self.peak_flops
        if kind == "f32":
            return self.f32_flops or self.peak_flops
        if kind == "bf16":
            return self.peak_flops
        raise KeyError(f"unknown operation kind {kind!r}")


# The reference's named machine classes, with its numbers ("tpu" the v5e
# assignment target and the default ``HW()``; "gpu" an A100-80G-class part;
# "cpu" a server socket), and the port's own "h100": an NVIDIA H100 SXM's
# dense bf16 tensor-core rate (989e12), dense int8 (1979e12), f32 outside
# the tensor cores (67e12), HBM3 at 3.35e12 B/s and 80 GB; the link rate is
# NVIDIA's H100 SXM fourth-generation NVLink figure, 900 GB/s of total
# bandwidth per GPU (18 links), counted as the reference counts the A100's
# 600 GB/s NVLink for "gpu".
HW_PROFILES: dict[str, HW] = {
    "tpu": HW(),
    "gpu": HW(peak_flops=312e12, hbm_bw=2.0e12, ici_bw=600e9,
              hbm_per_chip=80e9, name="gpu"),
    "cpu": HW(peak_flops=2e12, hbm_bw=100e9, ici_bw=30e9,
              hbm_per_chip=64e9, name="cpu"),
    "h100": HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=900e9,
               hbm_per_chip=80e9, name="h100", int8_ops=1979e12, f32_flops=67e12),
}


def hw_profile(name: str | None = None) -> HW:
    """Resolve a named :class:`HW` profile.

    ``None`` / ``"auto"`` selects by the machine: a CUDA card whose name
    holds "H100" gives ``h100``, another CUDA card ``gpu`` (the reference
    falls back by class), no CUDA ``cpu``. An unknown name raises."""
    if name in (None, "auto"):
        import torch

        if not torch.cuda.is_available():
            return HW_PROFILES["cpu"]
        if "H100" in torch.cuda.get_device_name():
            return HW_PROFILES["h100"]
        return HW_PROFILES["gpu"]
    prof = HW_PROFILES.get(name)
    if prof is None:
        raise KeyError(f"unknown hw profile {name!r}; have {sorted(HW_PROFILES)}")
    return prof


# kind -> (the byte basis, its multiplier): the reference's table
COLLECTIVE_PRICE = {
    "all-reduce": ("result", 2.0),
    "all-gather": ("result", 1.0),
    "reduce-scatter": ("operand", 1.0),
    "all-to-all": ("result", 1.0),
    "collective-permute": ("result", 1.0),
}


def collective_charge(kind: str, operand_bytes: float, result_bytes: float) -> float:
    """The roofline bytes of one ``kind`` collective whose operand and
    result on this chip are ``operand_bytes`` and ``result_bytes``."""
    basis, mult = COLLECTIVE_PRICE[kind]
    return mult * (result_bytes if basis == "result" else operand_bytes)


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def merge_line(self, kind: str, nbytes: float):
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def charge(self, kind: str, operand_bytes: float, result_bytes: float) -> float:
        """Price one call by :data:`COLLECTIVE_PRICE` and merge it; returns
        its bytes."""
        nbytes = collective_charge(kind, operand_bytes, result_bytes)
        self.merge_line(kind, nbytes)
        return nbytes


@dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops: float            # per device (counted ops: the reference's HLO FLOPs)
    hlo_bytes: float            # per device
    collective_bytes: float     # per device
    model_flops: float          # global, 6·N_active·D
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    bound_s: float = 0.0
    useful_ratio: float = 0.0   # MODEL_FLOPS / (FLOPs × chips)
    mfu: float = 0.0            # MODEL_FLOPS / (bound_s × chips × peak)
    collectives: dict = field(default_factory=dict)
    memory_per_chip: float = 0.0
    hw: str = ""                # the profile's name

    def table_row(self) -> str:
        return (
            f"| {self.name} | {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} | "
            f"{self.collective_s*1e3:.2f} | {self.dominant} | {self.useful_ratio:.2f} | "
            f"{self.mfu*100:.1f}% |"
        )


def analyze(
    name: str,
    *,
    chips: int,
    cost,
    model_flops: float,
    hw: HW | None = None,
    memory_per_chip: float = 0.0,
) -> RooflineReport:
    """Three-term roofline of a counted ``cost`` (anything with ``flops``,
    ``hbm_bytes``, ``collective_bytes`` and ``collectives``: an
    ``op_cost.OpCost``), priced on ``hw`` (default: ``h100``)."""
    hw = HW_PROFILES["h100"] if hw is None else hw
    flops, nbytes = float(cost.flops), float(cost.hbm_bytes)
    r = RooflineReport(
        name=name,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=nbytes,
        collective_bytes=float(cost.collective_bytes),
        model_flops=model_flops,
        collectives={**cost.collectives},
        memory_per_chip=memory_per_chip,
        hw=hw.name,
    )
    r.compute_s = flops / hw.peak_flops
    r.memory_s = nbytes / hw.hbm_bw
    r.collective_s = r.collective_bytes / hw.ici_bw
    terms = {
        "compute": r.compute_s,
        "memory": r.memory_s,
        "collective": r.collective_s,
    }
    r.dominant = max(terms, key=terms.get)
    r.bound_s = max(terms.values())
    total = flops * chips
    r.useful_ratio = model_flops / total if total else 0.0
    denom = r.bound_s * chips * hw.peak_flops
    r.mfu = model_flops / denom if denom else 0.0
    return r
