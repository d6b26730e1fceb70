"""Hierarchical wall-clock tracing — the reference's start_timer!/end_timer!.

Mirrors mpc-net/src/utils/timer.rs: indented, colored Start:/End: lines
with durations, gated by a global enable flag (the reference gates on
``net.is_leader()``; here tracing is process-global since all parties
share the process).  Additionally wraps the region in
``jax.profiler.TraceAnnotation``-compatible ``jax.named_scope`` so the
spans show up in device profiler traces.
"""

from __future__ import annotations

import contextlib
import sys
import time

import jax

_ENABLED = False
_INDENT = 0
_RECORDS: list[tuple[str, float]] = []


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def records():
    """List of (label, seconds) for all closed spans since last clear."""
    return list(_RECORDS)


def clear():
    _RECORDS.clear()


@contextlib.contextmanager
def trace(label: str, enabled: bool = True):
    """``with trace("Commit"):`` — timed, indented, profiler-annotated."""
    global _INDENT
    show = _ENABLED and enabled
    if show:
        print("  " * _INDENT + f"Start: {label}", flush=True, file=sys.stderr)
        _INDENT += 1
    t0 = time.perf_counter()
    with jax.named_scope(label.replace(" ", "_")):
        yield
    dt = time.perf_counter() - t0
    _RECORDS.append((label, dt))
    if show:
        _INDENT -= 1
        print(
            "  " * _INDENT + f"End:   {label} {dt*1e3:.3f}ms",
            flush=True,
            file=sys.stderr,
        )
