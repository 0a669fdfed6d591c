"""Per-layer tuGEMM statistics -> §IV PPA / energy report.

Takes the GEMMs an eager :func:`~repro_torch.quant.capture.capture_stats`
collected (a :class:`~repro_torch.quant.capture.Capture`: one
``CapturedGemm`` per executed GEMM, layer by layer) and multiplies the
measured serial/parallel cycle counts against the analytic PPA model
calibrated to the paper's Table I (``core.ppa``):

- every GEMM is charged on a unit sized to its own (M, K, N) via
  ``evaluate_ppa`` (the ``S_eff = sqrt(M·N)`` generalization of the square
  calibration points) at the bitwidth that GEMM ran at: under a
  mixed-precision QuantPolicy each row carries its own bits, clock and
  Table-I operating point, and the report adds per-bitwidth subtotals
  (``by_bits``);
- distinct GEMMs time-multiplex one unit even in the parallel
  micro-architecture (its parallelism is across the K outer-product steps
  within one GEMM), so cycles sum over GEMMs for both variants;
- the report also restates the workload on the paper's fixed 16×16
  evaluation unit (``unit_*``; the same per-bits cycle totals, each at its
  Table-I power and clock) and carries the uGEMM baseline comparison.

The reference reads a stats tree whose nodes stack layers along scan axes,
so one of its rows covers every layer of a stacked GEMM (``instances`` =
layers); the port's capture is flat, so each row is one executed GEMM
(``instances`` = 1) labelled ``name#i`` (the i-th GEMM of that name). The
totals, ``by_bits``, ``unit_*``, ``baseline`` and ``interconnect`` are the
reference's for the same GEMMs.

Host-side: call on an executed capture.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .ppa import UGEMM_BASELINE, evaluate_ppa, ppa_model

__all__ = [
    "LayerEnergy",
    "EnergyReport",
    "energy_report",
    "ugemm_comparison",
    "slot_energy",
    "spec_energy_summary",
    "INTERCONNECT_PJ_PER_BYTE",
]

# Interconnect energy price for the sharded-serving byte meter
# (``Scheduler.comms_summary``): edge-class chip-to-chip links run ~5-20 pJ/bit;
# we charge a flat 10 pJ/bit = 80 pJ/byte on *wire* bytes (quantized
# payload + scales), which is exactly the term quantize-before-all-gather
# shrinks by bits/16 versus gathering bf16 activations.
INTERCONNECT_PJ_PER_BYTE = 80.0


@dataclass(frozen=True)
class LayerEnergy:
    """One captured GEMM's measured cycles, mapped to PPA at its bitwidth."""

    label: str            # "name#i": the i-th captured GEMM of that name
    bits: int             # bitwidth this GEMM ran at (mixed policies differ per row)
    M: int
    K: int                # contraction dim (the paper's N)
    N: int                # output dim (the paper's P)
    instances: int        # sequential GEMM executions (1 per captured GEMM)
    serial_cycles: int
    parallel_cycles: int
    max_abs: int          # Fig 5 statistic, max over instances
    area_mm2: float       # unit sized to this GEMM, chosen variant
    power_w: float
    latency_s: float      # cycles / achievable clock at this bitwidth
    energy_j: float

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N * self.instances


def ugemm_comparison(bits: int, variant: str) -> dict:
    """tuGEMM vs the rate-coded uGEMM baseline at the paper's comparison
    point (16×16 unit; uGEMM numbers are its 8-bit Table I row)."""
    m = ppa_model(variant)
    area = m.area_mm2(bits, 16, 16, 16)
    power = m.power_w(bits, 16, 16, 16)
    return {
        "tugemm_area_mm2": area,
        "tugemm_power_w": power,
        "ugemm_area_mm2": UGEMM_BASELINE["area_mm2"],
        "ugemm_power_w": UGEMM_BASELINE["power_w"],
        "area_ratio": UGEMM_BASELINE["area_mm2"] / area,
        "power_ratio": UGEMM_BASELINE["power_w"] / power,
    }


@dataclass
class EnergyReport:
    bits: int | None                  # uniform bitwidth, or None = mixed policy
    variant: str                      # serial | parallel
    layers: list[LayerEnergy] = field(default_factory=list)
    total_cycles: int = 0
    total_macs: int = 0
    total_latency_s: float = 0.0      # time-multiplexed: sum over GEMMs
    total_energy_j: float = 0.0
    # the same workload on the paper's fixed 16×16 evaluation unit; under a
    # mixed policy each bits-bucket runs at its own clock/power and the
    # latency/energy sum over buckets
    unit_power_w: float = 0.0
    unit_latency_s: float = 0.0
    unit_energy_j: float = 0.0
    baseline: dict = field(default_factory=dict)
    # per-bitwidth subtotal rollup: bits -> {layers, cycles, macs,
    # latency_s, energy_j, unit_latency_s, unit_energy_j, baseline}
    by_bits: dict = field(default_factory=dict)
    # sharded serving: bytes each quantized collective moved, priced at
    # INTERCONNECT_PJ_PER_BYTE — bits -> {bytes_moved, bf16_bytes, energy_j}
    interconnect: dict = field(default_factory=dict)
    interconnect_energy_j: float = 0.0
    # dispatch paths: {"paths": {name: {path: n}}, "fallbacks": {name:
    # {reason: n}}} (``paths`` from kernels.ops.path_counts) — which path
    # (cuda kernel or plain torch) each GEMM's cycles came from
    kernels: dict = field(default_factory=dict)

    @property
    def is_mixed(self) -> bool:
        return len(self.by_bits) > 1

    def render(self, top: int = 12) -> str:
        label = f"{self.bits}-bit" if not self.is_mixed and self.bits else "mixed-precision"
        hdr = (
            f"tuGEMM energy report — {label} {self.variant} "
            f"({len(self.layers)} GEMMs, {self.total_macs/1e6:.2f} MMACs)"
        )
        lines = [hdr, f"{'layer':<36} {'bits':>4} {'MxKxN':>16} {'inst':>5} "
                      f"{'cycles':>12} {'energy':>10} {'share':>6}"]
        tot = max(self.total_energy_j, 1e-30)
        for le in sorted(self.layers, key=lambda l: -l.energy_j)[:top]:
            cyc = le.serial_cycles if self.variant == "serial" else le.parallel_cycles
            lines.append(
                f"{le.label:<36} {le.bits:>4} {f'{le.M}x{le.K}x{le.N}':>16} {le.instances:>5} "
                f"{cyc:>12} {le.energy_j*1e6:>8.2f}uJ {100*le.energy_j/tot:>5.1f}%"
            )
        for b in sorted(self.by_bits, reverse=True):
            s = self.by_bits[b]
            lines.append(
                f"  int{b} subtotal: {s['layers']} GEMMs, {s['cycles']} cycles, "
                f"{s['energy_j']*1e6:.2f} uJ ({100*s['energy_j']/tot:.1f}%)"
            )
        for b in sorted(self.interconnect, reverse=True):
            ic = self.interconnect[b]
            saved = ic["bf16_bytes"] - ic["bytes_moved"]
            lines.append(
                f"  wire int{b}: {ic['bytes_moved']} B moved, "
                f"{ic['energy_j']*1e6:.3f} uJ interconnect "
                f"(bf16 would move {ic['bf16_bytes']} B; saved {saved} B)"
            )
        lines.append(
            f"total: {self.total_cycles} cycles, {self.total_latency_s*1e3:.3f} ms, "
            f"{self.total_energy_j*1e6:.2f} uJ "
            f"(16x16 unit: {self.unit_latency_s*1e3:.3f} ms, "
            f"{self.unit_energy_j*1e6:.2f} uJ)"
        )
        if self.interconnect_energy_j:
            lines.append(
                f"interconnect total: {self.interconnect_energy_j*1e6:.3f} uJ "
                f"at {INTERCONNECT_PJ_PER_BYTE:.0f} pJ/B"
            )
        paths = self.kernels.get("paths", {})
        if paths:
            by_path: dict[str, int] = {}
            for counts in paths.values():
                for p, n in counts.items():
                    by_path[p] = by_path.get(p, 0) + n
            frag = ", ".join(f"{p}={n}" for p, n in sorted(by_path.items()))
            lines.append(f"kernel paths: {frag}")
            for gname, reasons in sorted(self.kernels.get("fallbacks", {}).items()):
                why = ", ".join(f"{r}x{n}" for r, n in sorted(reasons.items()))
                lines.append(f"  fallback {gname}: {why}")
        if self.baseline:
            b = self.baseline
            lines.append(
                f"vs uGEMM 16x16: {b['area_ratio']:.1f}x less area, "
                f"{b['power_ratio']:.1f}x less power at w={self.bits}"
            )
        elif self.is_mixed:
            for b in sorted(self.by_bits, reverse=True):
                r = self.by_bits[b]["baseline"]
                lines.append(
                    f"vs uGEMM 16x16 at w={b}: {r['area_ratio']:.1f}x less area, "
                    f"{r['power_ratio']:.1f}x less power"
                )
        return "\n".join(lines)


def _entries(capture) -> list:
    """[(label, CapturedGemm)] of a Capture (labels ``name#i``), or the
    list as given."""
    if isinstance(capture, (list, tuple)):
        return list(capture)
    seen: dict[str, int] = {}
    out = []
    for e in capture.entries:
        i = seen.get(e.name, 0)
        seen[e.name] = i + 1
        out.append((f"{e.name}#{i}", e))
    return out


def _host_ints(e) -> tuple[int, int, int, int]:
    """(serial cycles, parallel cycles, instances, max |value|) of one entry,
    read from the device in one transfer."""
    st = e.stats
    ser = torch.as_tensor(st.serial_cycles).to(torch.int64)
    vals = torch.stack([ser.sum(), torch.as_tensor(st.parallel_cycles).to(torch.int64).sum(),
                        torch.as_tensor(st.max_abs).to(torch.int64).max()]).tolist()
    return vals[0], vals[1], ser.numel(), vals[2]


def energy_report(
    capture, *, bits: int | None = None, variant: str = "serial",
    comms: dict | None = None, kernels: dict | None = None,
) -> EnergyReport:
    """Roll captured GEMMs up into the PPA/energy report.

    ``capture`` is a :class:`~repro_torch.quant.capture.Capture` or a list
    of ``(label, CapturedGemm)``. ``bits=None`` (the default for
    mixed-precision policies) charges every GEMM at the bitwidth recorded
    in its CapturedGemm; an explicit ``bits`` overrides uniformly.

    ``comms`` is any dict with a ``by_bits`` entry of ``{bits:
    {payload_bytes, scale_bytes, bf16_bytes}}``: the bytes each quantized
    collective moved become the interconnect column at
    ``INTERCONNECT_PJ_PER_BYTE``. ``kernels`` is a dispatch snapshot
    ``{"paths": {name: {path: n}}, "fallbacks": {...}}`` (``paths`` as
    ``kernels.ops.path_counts`` gives it); the render then shows which path
    each GEMM took."""
    if variant not in ("serial", "parallel"):
        raise ValueError(f"unknown tuGEMM variant {variant!r}")
    rep = EnergyReport(bits=bits, variant=variant, kernels=dict(kernels or {}))
    for label, e in _entries(capture):
        ebits = int(bits if bits is not None else e.bits)
        ser, par, inst, mx = _host_ints(e)
        cyc = ser if variant == "serial" else par
        unit = evaluate_ppa(variant, ebits, e.M, e.K, e.N, cyc)
        rep.layers.append(LayerEnergy(
            label=label, bits=ebits, M=e.M, K=e.K, N=e.N, instances=inst,
            serial_cycles=ser, parallel_cycles=par,
            max_abs=mx,
            area_mm2=unit.area_mm2, power_w=unit.power_w,
            latency_s=unit.latency_s, energy_j=unit.energy_j,
        ))
        le = rep.layers[-1]
        rep.total_cycles += cyc
        rep.total_macs += le.macs
        rep.total_latency_s += unit.latency_s
        rep.total_energy_j += unit.energy_j
        sub = rep.by_bits.setdefault(ebits, {
            "layers": 0, "cycles": 0, "macs": 0,
            "latency_s": 0.0, "energy_j": 0.0,
            "unit_latency_s": 0.0, "unit_energy_j": 0.0,
            "baseline": ugemm_comparison(ebits, variant),
        })
        sub["layers"] += 1
        sub["cycles"] += cyc
        sub["macs"] += le.macs
        sub["latency_s"] += unit.latency_s
        sub["energy_j"] += unit.energy_j

    # 16×16-unit restatement: each bits bucket at its own clock and power
    for b, sub in rep.by_bits.items():
        lat, e_j = slot_energy(b, variant, sub["cycles"])
        sub["unit_latency_s"], sub["unit_energy_j"] = lat, e_j
        rep.unit_latency_s += lat
        rep.unit_energy_j += e_j
    if rep.unit_latency_s > 0:
        rep.unit_power_w = rep.unit_energy_j / rep.unit_latency_s
    if len(rep.by_bits) == 1:
        only = next(iter(rep.by_bits))
        if rep.bits is None:
            rep.bits = only
        rep.baseline = rep.by_bits[only]["baseline"]
    elif rep.bits is not None:
        rep.baseline = ugemm_comparison(rep.bits, variant)
        rep.unit_power_w = ppa_model(variant).power_w(rep.bits, 16, 16, 16)
    if comms:
        for b, r in comms.get("by_bits", comms).items():
            moved = int(r.get("payload_bytes", 0)) + int(r.get("scale_bytes", 0))
            e_j = moved * INTERCONNECT_PJ_PER_BYTE * 1e-12
            rep.interconnect[int(b)] = {
                "bytes_moved": moved,
                "bf16_bytes": int(r.get("bf16_bytes", 0)),
                "energy_j": e_j,
            }
            rep.interconnect_energy_j += e_j
    return rep


def spec_energy_summary(entries: list[dict]) -> dict:
    """Speculative-decoding fleet rollup over per-request ``SlotMeter.energy()``
    dicts (``serve.scheduler.Scheduler.energy_summary``; ``spec_summary``
    adds the speculative engine's counters).

    "Accepted tokens" are the tokens a run actually kept — every one was
    target-verified (an accepted draft, a rejection correction, a bonus
    sample, or a prefill sample). The energy totals deliberately include
    everything spent *around* them: the draft pass at the draft policy's
    bitwidths (``draft_energy_j``), the verify cycles of rejected candidate
    positions, and the draft cycles proportional to rejected proposals
    (``wasted_draft_energy_j``). ``energy_per_accepted_token_j`` is therefore
    the honest deployment number: joules of tuGEMM work per token kept, waste
    and all — the metric the int2-draft design is meant to win on."""
    gen = sum(e.get("generated_tokens", 0) for e in entries)
    tot = sum(e.get("energy_j", 0.0) for e in entries)
    lat = sum(e.get("latency_s", 0.0) for e in entries)
    draft = sum(e.get("draft_energy_j", 0.0) for e in entries)
    drafted = sum(e.get("drafted_tokens", 0) for e in entries)
    accepted = sum(e.get("accepted_draft_tokens", 0) for e in entries)
    rate = accepted / drafted if drafted else 0.0
    return {
        "requests": len(entries),
        "generated_tokens": gen,
        "drafted_tokens": drafted,
        "accepted_draft_tokens": accepted,
        "acceptance_rate": rate,
        "energy_j": tot,
        "latency_s": lat,
        "draft_energy_j": draft,
        "target_energy_j": tot - draft,
        "wasted_draft_energy_j": draft * (1.0 - rate),
        "energy_per_accepted_token_j": (tot / gen) if gen else 0.0,
        "accepted_tokens_per_j": (gen / tot) if tot > 0 else 0.0,
    }


def slot_energy(bits: int, variant: str, cycles: int) -> tuple[float, float]:
    """(latency_s, energy_j) for ``cycles`` on the paper's 16×16 evaluation
    unit — the per-slot accounting model (one shared unit, time-multiplexed
    across requests)."""
    m = ppa_model(variant)
    lat = cycles / m.clock_hz(bits)
    return lat, m.power_w(bits, 16, 16, 16) * lat
