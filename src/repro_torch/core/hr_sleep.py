"""Userspace adaptation of the paper's ``hr_sleep()`` kernel service.

The paper's hr_sleep() is a Linux kernel module: it passes the sleep period
in a register (no cross-ring copy), keeps the timer entry on the kernel
stack (no allocator), and thereby starts the hrtimer with minimal preamble,
achieving ~15x better precision than nanosleep() for SCHED_OTHER threads
(paper Table 1).

We cannot load kernel modules here, so we implement the closest userspace
equivalent — a *hybrid* sleep:

  1. bulk:  ``time.sleep()`` (CPython -> clock_nanosleep(CLOCK_MONOTONIC))
            for ``target - margin`` where ``margin`` is the calibrated p99
            overshoot of the underlying timer on this host;
  2. tail:  a bounded spin on ``perf_counter_ns`` for the residual.

The API contract mirrors the paper: a single scalar (nanoseconds), no
per-call allocation on the hot path.  Like the paper's patched variant
(Sec 5.4) sub-microsecond requests may return immediately when
``sub_us_immediate=True``.

Precision is *measured*, never assumed: ``measure_precision`` reproduces the
structure of paper Table 1 (mean / p99 achieved sleep for a sweep of
targets) for both this hybrid sleep and the naive baseline, and
benchmarks/bench_sleep_precision.py reports it.

Trade-off vs the paper (documented in DESIGN.md): the spin tail burns CPU
for up to ``margin`` ns per call, whereas the kernel module sleeps the whole
interval.  ``margin`` is therefore calibrated as small as the host's timer
jitter allows, and callers that prefer zero spin (pure CPU saving, paper
semantics) can use ``naive_sleep`` or ``hr_sleep(..., spin_cap_ns=0)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

__all__ = [
    "SleepCalibration",
    "calibrate",
    "naive_sleep",
    "hr_sleep",
    "make_hr_sleep",
    "measure_precision",
]

_NS = 1e-9


@dataclass(frozen=True)
class SleepCalibration:
    """Host timer characteristics measured at import/calibration time."""

    margin_ns: int          # p99 overshoot of time.sleep for us-scale targets
    min_sleep_ns: int       # mean achieved duration of time.sleep(probe_ns)
    spin_resolution_ns: int  # granularity of perf_counter_ns spin loop


def calibrate(samples: int = 200, probe_ns: int = 1_000) -> SleepCalibration:
    """Measure the naive timer's overshoot so the hybrid knows its margin.

    ``margin_ns`` is the p99 overshoot of ``time.sleep(probe_ns)``,
    floored at both the measured spin resolution (a margin the spin
    loop cannot even resolve buys no precision, it only burns CPU) and
    1us (the smallest bulk/spin split worth making);
    ``min_sleep_ns`` is the mean *achieved* duration of a
    ``time.sleep(probe_ns)`` request — the shortest sleep this host's
    timer can actually deliver at the probe scale, i.e. ``probe_ns``
    plus the mean overshoot."""
    overshoot = np.empty(samples)
    for i in range(samples):
        t0 = time.perf_counter_ns()
        time.sleep(probe_ns * _NS)
        overshoot[i] = time.perf_counter_ns() - t0 - probe_ns
    # Spin-loop granularity: consecutive perf_counter_ns deltas.
    t = [time.perf_counter_ns() for _ in range(64)]
    deltas = np.diff(t)
    res = int(max(np.median(deltas), 1))
    margin = int(np.percentile(overshoot, 99))
    return SleepCalibration(
        margin_ns=max(margin, res, 1_000),
        min_sleep_ns=int(np.mean(overshoot)) + probe_ns,
        spin_resolution_ns=res,
    )


_CAL: SleepCalibration | None = None


def _get_cal() -> SleepCalibration:
    global _CAL
    if _CAL is None:
        _CAL = calibrate()
    return _CAL


def naive_sleep(duration_ns: int) -> None:
    """Baseline: plain clock_nanosleep — the paper's ``nanosleep()`` arm."""
    time.sleep(duration_ns * _NS)


def hr_sleep(
    duration_ns: int,
    *,
    sub_us_immediate: bool = False,
    spin_cap_ns: int | None = None,
) -> None:
    """Precise hybrid sleep for ``duration_ns`` nanoseconds.

    ``spin_cap_ns`` bounds the CPU-burning tail; ``None`` uses the calibrated
    margin, ``0`` degenerates to the naive timer (paper-pure CPU semantics).
    """
    if sub_us_immediate and duration_ns < 1_000:
        return  # paper Sec 5.4: patched immediate return for sub-us requests
    cal = _get_cal()
    deadline = time.perf_counter_ns() + duration_ns
    margin = cal.margin_ns if spin_cap_ns is None else spin_cap_ns
    bulk = duration_ns - margin
    if bulk > 0:
        time.sleep(bulk * _NS)
    if margin == 0:
        if bulk <= 0:
            time.sleep(duration_ns * _NS)
        return
    while time.perf_counter_ns() < deadline:
        pass  # bounded by `margin` ns


def make_hr_sleep(**kwargs):
    """Bind hr_sleep options once; returns a 1-arg callable for hot loops."""
    def _sleep(duration_ns: int) -> None:
        hr_sleep(duration_ns, **kwargs)
    return _sleep


def measure_precision(sleep_fn, targets_ns, samples: int = 300):
    """Paper Table 1 methodology: wall-clock between invoke and resume.

    Returns {target_ns: (mean_ns, p99_ns)} of the *achieved* sleep length.
    """
    out = {}
    for tgt in targets_ns:
        achieved = np.empty(samples)
        for i in range(samples):
            t0 = time.perf_counter_ns()
            sleep_fn(int(tgt))
            achieved[i] = time.perf_counter_ns() - t0
        out[int(tgt)] = (float(np.mean(achieved)), float(np.percentile(achieved, 99)))
    return out
