"""Per-stage timing + throughput accounting (ScopedTimer/PROFILE_* analog).

The reference gates RAII microsecond timers behind compile-time flags
(the reference's PvDefinitions.h:31-58, Util/ScopedTimer.h). Here timing is
always collected (cheap) and surfaced as a structured dict; cell-updates/s
and recording-bandwidth metrics derive from the grid parameters.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["StageTimer", "Stats", "throughput", "device_trace",
           "time_block"]


def time_block(fn, n: int = 10, warmup: int = 1) -> dict:
    """Wall time of ``fn()`` per call, each call ended by
    ``jax.block_until_ready`` on its result (JAX returns before the device
    finishes, so a timing without it measures the enqueue):
    {"median_s", "min_s", "max_s", "n"} over ``n`` calls after ``warmup``
    untimed ones (the first compiles)."""
    import jax
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(times)), "min_s": float(np.min(times)),
            "max_s": float(np.max(times)), "n": n}


class Stats:
    """Rolling per-stage wall-clock stats."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.last: dict[str, float] = {}

    def record(self, stage: str, seconds: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1
        self.last[stage] = seconds

    def mean(self, stage: str) -> float:
        c = self.counts.get(stage, 0)
        return self.totals.get(stage, 0.0) / c if c else 0.0

    def summary(self) -> dict:
        return {s: {"mean_s": self.mean(s), "last_s": self.last[s],
                    "count": self.counts[s]} for s in self.totals}


class StageTimer:
    def __init__(self, stats: Stats | None = None):
        self.stats = stats or Stats()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats.record(name, time.perf_counter() - t0)


def throughput(params, seconds: float) -> dict:
    """Work accounting for one sim pass: cell updates and recording bytes,
    and their rates over ``seconds``."""
    cells = params.nx * params.ny
    updates = cells * params.response_length
    rec_bytes = updates * 4  # f32 pressure recording
    return {
        "cell_updates": updates,
        "cell_updates_per_s": updates / seconds if seconds > 0 else 0.0,
        "recording_bytes": rec_bytes,
        "recording_gb_per_s": rec_bytes / seconds / 1e9 if seconds > 0 else 0.0,
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace around a block (inspect with
    TensorBoard / xprof) — the device-side analog of the reference's
    PROFILE_SECTION macros."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
