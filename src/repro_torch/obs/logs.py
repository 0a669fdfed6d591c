"""Structured logging helper: one grep-able ``event key=value ...`` line
(a copy of the reference's ``repro/obs/logs.py``).

Request forensics need ``grep rid=17`` to work on a server log. The serve
layer's messages therefore render through :func:`kv` instead of free-form
prose: a short event name followed by sorted-stable ``key=value`` pairs,
values repr-quoted only when they contain whitespace or ``=``.

    >>> kv("stall", rows=2, clock=14, ladder="preempt")
    'stall rows=2 clock=14 ladder=preempt'

Conventions (DESIGN.md §14): ``rid=`` request id, ``tenant=``, ``tick=``
the scheduler's logical clock, ``reason=`` a RejectReason, ``ladder=`` the
level name. Keys keep their call-site order — put the grep keys first.
"""

from __future__ import annotations

__all__ = ["kv"]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    if any(c in s for c in (" ", "=", '"', "\n")) or not s:
        return repr(s)
    return s


def kv(event: str, **fields) -> str:
    """Render ``event key=value ...`` (see module docstring)."""
    if not fields:
        return event
    return event + " " + " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
