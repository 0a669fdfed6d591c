"""Sharding-context reporting (the reference's ``repro/launch/ctx_report.py``):
the accounting of a :class:`~repro_torch.parallel.sharding.MeshContext` as
a dry-run row / ``health()`` block and as printable lines, one code path
for both."""

from __future__ import annotations

__all__ = ["sharding_report", "format_dropped_rules"]


def sharding_report(ctx) -> dict:
    """The context-accounting block a dry-run row / health snapshot carries:
    divisibility replications (counted, warned once a site) and rules whose
    mesh axes were absent at ``use_mesh()`` time (recorded, never silently
    vanished: the "pod"-axis rule on a pod-less mesh)."""
    if ctx is None:
        return {"replicated_dims": 0, "dropped_rules": {}}
    return {
        "replicated_dims": int(ctx.replicated_dims),
        "dropped_rules": {str(k): v for k, v in ctx.dropped_rules.items()},
    }


def format_dropped_rules(ctx) -> list[str]:
    """Human-readable lines, one a dropped rule; empty when clean."""
    rep = sharding_report(ctx)
    lines = [
        f"sharding: rule {name!r} -> {ax!r} dropped (axis absent from mesh)"
        for name, ax in sorted(rep["dropped_rules"].items())
    ]
    if rep["replicated_dims"]:
        lines.append(
            f"sharding: {rep['replicated_dims']} dim(s) replicated on "
            "non-dividing mesh axes (see ReplicatedDimWarning)"
        )
    return lines
