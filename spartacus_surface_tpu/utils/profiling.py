"""Profiling hooks: the Dr-Hook equivalent.

The reference brackets every significant routine with
`if (lhook) call dr_hook(name, 0/1, handle)` (utilities/yomhook.F90:18-31,
used e.g. at radsurf/radsurf_interface.F90:83,315) and times the solver loop
with omp_get_wtime (driver/spartacus_surface_driver.F90:195,264-268).

Equivalents provided here:
  * `hook(name)`: context manager accumulating wall time per region (a
    no-op unless enabled, like lhook);
  * `annotate(name)`: jax.profiler.TraceAnnotation so regions show up in
    JAX profiler traces (plus jax.named_scope inside jit);
  * `start_trace(dir)` / `stop_trace()`: full XLA device trace capture.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

enabled = False
_totals: defaultdict[str, float] = defaultdict(float)
_counts: defaultdict[str, int] = defaultdict(int)


@contextlib.contextmanager
def hook(name: str):
    """Accumulating wall-clock region timer (dr_hook equivalent)."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    _totals[name] += dt
    _counts[name] += 1


def annotate(name: str):
    """Named scope for jitted code regions (shows in profiler traces)."""
    return jax.named_scope(name)


def report(printer=print):
    """Print accumulated region times, Dr-Hook-summary style."""
    if not _totals:
        return
    printer("Profiling summary (wall seconds):")
    width = max(len(k) for k in _totals)
    for name in sorted(_totals, key=_totals.get, reverse=True):
        printer(
            f"  {name:<{width}}  {_totals[name]:10.4f} s"
            f"  ({_counts[name]} calls)"
        )


def reset():
    _totals.clear()
    _counts.clear()


def start_trace(log_dir: str):
    jax.profiler.start_trace(log_dir)


def stop_trace():
    jax.profiler.stop_trace()
