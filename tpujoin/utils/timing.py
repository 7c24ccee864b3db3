"""Wall-clock timing + roofline accounting.

The engine's analogue of the reference's startTimer/endTimer brackets
(reference shared_stuff/shared.cpp:10-31) — with the async-launch pitfall
fixed: the reference's brackets mostly measured kernel *launches* because
lowering inserts -gpu-async-region (reference run_test.sh:24), so its
published totals relied on Nsight. Here every measurement synchronizes via
``block_until_ready`` so the number is the kernel truth, and each phase can
carry a bytes-touched model so achieved HBM bandwidth (roofline fraction)
falls out — the deliverable BASELINE.json calls "per-operator roofline
accounting".
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import jax

from tpujoin.utils.hw import hbm_peak_gbps


@dataclasses.dataclass
class PhaseStat:
    name: str
    seconds: float
    bytes_touched: int = 0
    rows: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_touched / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.seconds if self.seconds > 0 else 0.0

    def as_dict(self) -> dict:
        d = {"phase": self.name, "seconds": self.seconds}
        if self.rows:
            d["rows_per_sec"] = self.rows_per_sec
        if self.bytes_touched:
            d["achieved_gbps"] = self.gbps
            peak = hbm_peak_gbps()
            if peak is not None:
                d["hbm_fraction"] = self.gbps / peak
        return d


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 1,
    iters: int = 3,
    name: str = "op",
    bytes_touched: int = 0,
    rows: int = 0,
) -> PhaseStat:
    """Median-of-iters wall time; every call ends in
    ``jax.block_until_ready`` on its outputs, so the time covers the
    device work and not only its dispatch. The warmup calls take the
    compiles."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return PhaseStat(name, times[len(times) // 2], bytes_touched, rows)


class Timer:
    """Accumulates named phase stats; prints the reference-style per-phase
    report (cf. "For k, time taken: N microseconds", shared.cpp:26-29) but
    as structured JSON."""

    def __init__(self):
        self.phases: list[PhaseStat] = []

    def measure(self, fn, *args, **kwargs) -> PhaseStat:
        stat = time_fn(fn, *args, **kwargs)
        self.phases.append(stat)
        return stat

    def add(self, stat: PhaseStat):
        self.phases.append(stat)

    def report(self) -> str:
        return json.dumps([p.as_dict() for p in self.phases], indent=2)
