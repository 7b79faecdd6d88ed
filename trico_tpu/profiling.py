"""Observability: per-stage timers, throughput counters, JAX profiler hooks.

The reference has only ad-hoc ``tic()/toc()`` in its tests (timer.h:7-23);
here tracing is a first-class subsystem: every codec stage can be timed with
:class:`StageTimer`, results aggregate into GB/s counters, and
:func:`trace` wraps a region in a ``jax.profiler`` trace for the device timeline
capture (view with TensorBoard / xprof).

Usage::

    from trico_tpu.profiling import StageTimer, trace

    prof = StageTimer()
    with prof.stage("transpose", nbytes=arr.nbytes):
        planes = transpose.aos_to_soa(arr, 3)
    with prof.stage("fp_encode", nbytes=arr.nbytes):
        ...
    print(prof.report())

    with trace("/tmp/trico-trace"):       # device timeline
        encode(...)
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


@dataclass
class _Stage:
    calls: int = 0
    seconds: float = 0.0
    nbytes: int = 0


@dataclass
class StageTimer:
    """Accumulates wall-clock + byte counts per named pipeline stage."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, sync=None):
        """Time a stage. Pass ``sync=jax.block_until_ready``-able output getter
        to include device completion (otherwise async dispatch time only)."""
        t0 = time.perf_counter()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            # only sync on success: on an exception the stage's outputs may
            # not exist (a sync lambda closing over unassigned names would
            # raise NameError from this finally and mask the real error)
            if ok and sync is not None:
                import jax

                jax.block_until_ready(sync() if callable(sync) else sync)
            dt = time.perf_counter() - t0
            s = self.stages.setdefault(name, _Stage())
            s.calls += 1
            s.seconds += dt
            s.nbytes += nbytes

    def gbps(self, name: str) -> float:
        s = self.stages.get(name)
        if not s or s.seconds == 0:
            return 0.0
        return s.nbytes / 1e9 / s.seconds

    def report(self) -> str:
        rows = []
        for name, s in self.stages.items():
            tp = f"{s.nbytes / 1e9 / s.seconds:7.2f} GB/s" if s.seconds and s.nbytes else "      -    "
            rows.append(f"{name:<24} {s.calls:>5}x {s.seconds*1e3:9.2f} ms {tp}")
        return "\n".join(rows)

    def as_json(self) -> str:
        return json.dumps(
            {
                name: {"calls": s.calls, "seconds": s.seconds, "bytes": s.nbytes,
                       "gbps": (s.nbytes / 1e9 / s.seconds) if s.seconds else 0.0}
                for name, s in self.stages.items()
            }
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX profiler trace for the enclosed region."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace annotation for a code region (shows up on the timeline)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
