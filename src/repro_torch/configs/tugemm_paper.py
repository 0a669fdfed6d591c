"""The paper's own hardware design points (Table I): serial/parallel ×
{2,4,8}-bit × {16×16, 32×32} tuGEMM units, as selectable configs for the
cycle simulator, PPA model and deployment planner (the port's own copy)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareConfig:
    name: str
    variant: str          # serial | parallel
    bitwidth: int         # 2 | 4 | 8
    m: int                # tile rows
    n: int                # common dim
    p: int                # tile cols
    clock_hz: float = 400e6   # paper synthesizes at 400 MHz (45 nm)


HW_CONFIGS: dict[str, HardwareConfig] = {}


def _reg(variant: str, bits: int, size: int) -> HardwareConfig:
    cfg = HardwareConfig(
        name=f"tugemm-{variant}-{bits}b-{size}x{size}",
        variant=variant,
        bitwidth=bits,
        m=size,
        n=size,
        p=size,
    )
    HW_CONFIGS[cfg.name] = cfg
    return cfg


for _v in ("serial", "parallel"):
    for _b in (2, 4, 8):
        for _s in (16, 32):
            _reg(_v, _b, _s)

PAPER_DEFAULT = HW_CONFIGS["tugemm-serial-8b-16x16"]
