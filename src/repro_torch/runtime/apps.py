"""Co-run application loads — the paper's Sec 5.6 CPU-sharing scenario.

Metronome's second headline claim is that sleep&wake retrieval leaves
the CPU it does not need to *other* work: an I/O task and a
CPU-intensive application can share cores, where DPDK-style busy polling
pins a full core forever.  This module makes that co-located
application a first-class object on both execution surfaces:

  - **real threads**: an ``AppLoad`` is a unit of competing application
    work that ``Runtime`` (and ``Server(..., app_load=...)``) co-runs on
    the host alongside the poller threads, counting the work it actually
    got done (``ops``) and the CPU it burned (``cpu_ns``) — the paper's
    Fig 15 "application throughput next to the dataplane" measurement;
  - **simulation**: ``co_run_config`` maps an app's CPU demand to the
    ``SimRunConfig`` interference model (per-wake preemption delays,
    correlated descheduling windows), so the event and batched engines
    can sweep co-location scenarios deterministically.

Two concrete loads:

  - ``DutyCycleBurner`` — a closed-loop CPU burner that wants
    ``demand`` of one core (burn ``demand * period``, sleep the rest):
    the canonical "CPU-intensive application" knob;
  - ``MatmulAppLoad`` — a ``torch.matmul`` step on the port's device
    (CUDA by default): a realistic compute tenant whose quantum is one
    device-synchronized matmul.

Contention model behind ``co_run_config`` (one CFS-scheduled core
hosting the I/O task and an app of demand ``a``):

  - a *sleep&wake* poller spends most time blocked, so the app runs in
    its gaps; the cost of co-location is per-wake — each timer fire
    lands on a busy core with probability ~``min(a, 1)`` and must wait
    out a wakeup-preemption delay — plus rare longer windows where the
    app (or kernel work on its behalf) cannot be preempted at all;
  - a *spinning* poller is always runnable, so CFS alternates it with
    the app in scheduler-quantum timeslices: the app's fair share
    against a spinner is ``min(a, 1/2)`` of the core, delivered as
    quantum-length windows during which the spinner is descheduled and
    retrieves nothing (modeled as correlated stall windows; the spin
    fluid model serves zero during them).  A closed-loop app with
    ``a <= 1/2`` still gets its work done (the spinner keeps
    ``1 - a``); past that the app saturates at half and the spinner
    collapses toward half its nominal service rate.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Protocol, runtime_checkable

from .simcore import SimRunConfig

__all__ = [
    "AppLoad",
    "DutyCycleBurner",
    "MatmulAppLoad",
    "co_run_config",
]


@runtime_checkable
class AppLoad(Protocol):
    """A unit of competing application work co-run with the pollers.

    Contract:
      - ``name``     label for benchmark rows;
      - ``threads``  how many app threads to deploy;
      - ``demand``   fraction of one core each thread *wants* (>= 1.0
                     means unthrottled / always runnable) — consumed by
                     the simulation mapping and equal-core accounting;
      - ``reset()``  re-arm internal state at run start;
      - ``step()``   run one quantum of work and return the work units
                     completed (called in a loop until the runtime
                     stops; must return promptly — quanta of ~1ms keep
                     stop() latency bounded).
    """

    name: str

    @property
    def threads(self) -> int: ...

    @property
    def demand(self) -> float: ...

    def reset(self) -> None: ...

    def step(self) -> int: ...


class DutyCycleBurner:
    """Closed-loop CPU burner: each quantum burns ``demand * period_us``
    of CPU (spin on the monotonic clock), then sleeps the remainder of
    the period.  ``demand >= 1`` never sleeps (an unthrottled tenant).
    ``ops`` counts completed quanta."""

    name = "duty-cycle-burner"

    def __init__(self, demand: float = 0.5, *, period_us: float = 1_000.0,
                 threads: int = 1):
        if demand < 0.0:
            raise ValueError("demand must be >= 0")
        self._demand = float(demand)
        self.period_us = float(period_us)
        self._threads = int(threads)

    @property
    def threads(self) -> int:
        return self._threads

    @property
    def demand(self) -> float:
        return self._demand

    def reset(self) -> None:
        pass

    def step(self) -> int:
        period_ns = int(self.period_us * 1e3)
        burn_ns = int(min(self._demand, 1.0) * period_ns)
        deadline = time.perf_counter_ns() + burn_ns
        while time.perf_counter_ns() < deadline:
            pass
        idle_ns = period_ns - burn_ns
        if idle_ns > 0:
            time.sleep(idle_ns / 1e9)
        return 1

    def __repr__(self) -> str:
        return (f"DutyCycleBurner(demand={self._demand}, "
                f"period_us={self.period_us}, threads={self._threads})")


class MatmulAppLoad:
    """A compute tenant on the port's PyTorch substrate: one quantum is
    one ``(n x n) @ (n x n)`` ``torch.matmul`` on ``device``,
    synchronized to completion (``torch.cuda.synchronize`` on a CUDA
    device), so each ``step()`` really occupies the device for the
    matmul's duration.  ``device`` defaults to ``"cuda"``; pass
    ``"cpu"`` to run the tenant on the host.  ``demand`` defaults to
    1.0 — an unthrottled tenant that takes whatever the scheduler gives
    it."""

    name = "matmul-app"

    def __init__(self, n: int = 256, *, threads: int = 1,
                 demand: float = 1.0, dtype=None, device="cuda"):
        self.n = int(n)
        self._threads = int(threads)
        self._demand = float(demand)
        self._dtype = dtype
        self.device = device
        self._x = None
        self._y = None

    @property
    def threads(self) -> int:
        return self._threads

    @property
    def demand(self) -> float:
        return self._demand

    def reset(self) -> None:
        # import lazily so the numpy-only paths never import torch
        import torch

        from .._device import resolve_device

        dev = resolve_device(self.device)
        dtype = self._dtype or torch.float32
        gen = torch.Generator().manual_seed(0)
        self._x = torch.randn((self.n, self.n), generator=gen).to(device=dev, dtype=dtype)
        self._y = torch.empty_like(self._x)
        self.step()                        # first call outside the loop

    def step(self) -> int:
        import torch

        if self._x is None:
            self.reset()
        # a fixed operand: every quantum is the same amount of work
        torch.matmul(self._x, self._x, out=self._y)
        if self._y.device.type == "cuda":
            torch.cuda.synchronize(self._y.device)
        return 1

    def __repr__(self) -> str:
        return f"MatmulAppLoad(n={self.n}, threads={self._threads})"


def _combine_bernoulli_exp(prob_a, mean_a, prob_b, mean_b):
    """Layer two Bernoulli x Exp delay sources: hit probabilities
    union (independent events), means combine weighted by each source's
    expected-delay contribution so the total E[delay] is preserved."""
    prob = 1.0 - (1.0 - prob_a) * (1.0 - prob_b)
    if prob <= 0.0:
        return 0.0, 0.0
    mean = (prob_a * mean_a + prob_b * mean_b) / prob
    return prob, mean


def _combine_stalls(cfg: SimRunConfig, new_rate: float, new_mean: float):
    """Layer a stall-window source onto ``cfg``'s: Poisson rates add,
    window means combine weighted by each source's rate contribution so
    the total stalled-time fraction (rate x mean) is preserved."""
    tot_rate = cfg.stall_rate_per_us + new_rate
    if tot_rate <= 0.0:
        return 0.0, 0.0
    mean = (cfg.stall_rate_per_us * cfg.stall_mean_us
            + new_rate * new_mean) / tot_rate
    return tot_rate, mean


def co_run_config(cfg: SimRunConfig, demand: float, *, spin: bool = False,
                  preempt_mean_us: float = 8.0,
                  pileup_every_us: float = 8_000.0,
                  pileup_mean_us: float = 120.0,
                  quantum_us: float = 250.0) -> SimRunConfig:
    """Derive the ``SimRunConfig`` for co-running an app of CPU demand
    ``demand`` (fraction of one core) next to the I/O task on one core.

    ``spin=False`` (sleep&wake poller): each wake lands on a busy core
    w.p. ``min(demand, 1)`` and waits an Exp(``preempt_mean_us``)
    wakeup-preemption delay; non-preemptible pile-ups add an
    Exp(``pileup_mean_us``) stall window every ``pileup_every_us /
    demand`` on average.

    ``spin=True`` (busy-polling poller): CFS deschedules the spinner
    for quantum-length windows whenever the app is runnable — the app's
    fair share against an always-runnable spinner is ``min(demand,
    0.5)``, delivered as Exp(``quantum_us``) stall windows at rate
    ``share / quantum_us`` (expected capacity loss = the share).  The
    spin fluid model (``repro.runtime.sim._simulate_spin``) serves
    nothing during stall windows, so latency spikes and ring overflows
    emerge exactly as on a shared host.

    Existing interference in ``cfg`` is layered, not overwritten:
    Bernoulli hit probabilities union, Exp means combine preserving the
    expected delay, stall rates add.
    """
    if demand < 0.0:
        raise ValueError("demand must be >= 0")
    if demand == 0.0:
        return cfg
    occ = min(demand, 1.0)
    if spin:
        share = min(demand, 0.5)
        tot_rate, stall_mean = _combine_stalls(cfg, share / quantum_us,
                                               quantum_us)
        return replace(cfg, stall_rate_per_us=tot_rate,
                       stall_mean_us=stall_mean)
    prob, mean = _combine_bernoulli_exp(
        cfg.interference_prob, cfg.interference_mean_us,
        occ, preempt_mean_us)
    tot_rate, stall_mean = _combine_stalls(cfg, occ / pileup_every_us,
                                           pileup_mean_us)
    return replace(cfg, interference_prob=prob,
                   interference_mean_us=mean,
                   stall_rate_per_us=tot_rate,
                   stall_mean_us=stall_mean)
