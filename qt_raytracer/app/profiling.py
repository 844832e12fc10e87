"""Profiling / observability hooks.

The reference's only instrumentation is QElapsedTimer + atomic counters
formatted into statsText (SURVEY.md §5). Device-side equivalents:

  - trace(): jax.profiler context writing an XPlane trace viewable in
    TensorBoard / Perfetto (kernel timings, memory traffic, collectives).
  - device_memory_stats(): live HBM usage per device.
  - annotate(): TraceAnnotation for custom spans inside the host loop.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Iterator

import jax

# Default trace directory, inside the checkout (listed in .gitignore).
TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "traces"


@contextlib.contextmanager
def trace(logdir: str = str(TRACE_DIR)) -> Iterator[None]:
    """Capture a device trace for everything inside the context.

    View with: tensorboard --logdir <logdir>  (Profile plugin), or load the
    .xplane.pb in Perfetto.
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a trace() capture (host-side annotation)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> list[dict]:
    """Per-device memory stats (bytes in use / limit) where supported."""
    out = []
    for dev in jax.devices():
        stats = {}
        try:
            stats = dict(dev.memory_stats() or {})
        except Exception:
            pass
        out.append({"device": str(dev), **stats})
    return out
