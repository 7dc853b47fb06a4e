"""The traced run's sources: spans around the engine's model calls, a slice
of the window under ``torch.profiler``, and what the metrics read from them.

``ModelProxy`` stands in for ``engine.model`` in a traced run: each
``prefill`` and ``decode_step`` becomes a ``Call`` (host clock, the call
synchronised on exit, so the device work it launched lies inside it), with
the prompt length or the live slots' positions.  ``DeviceSlice`` profiles
the card's operations (kernels, copies, fills) from its start to its stop;
its events and the calls share one clock (``time.time_ns``, the profiler's
own time base).
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field

from gpu_bench.bench import roofline

__all__ = ["Call", "Gate", "ModelProxy", "DeviceOp", "DeviceSlice", "busy_and_gaps", "label_of",
           "breakdown", "k1_share", "useful_flops", "unseen_calls", "K1_PREFIX"]

K1_PREFIX = "flash_fwd_"     # csrc/flash_attention.cu's kernels
COPIES = ("Memcpy", "Memset")   # the profiler's names for copies and fills, not kernels


@dataclass(frozen=True)
class Call:
    kind: str                  # "prefill" | "decode_step"
    start_ns: int
    end_ns: int
    bucket: int = 0            # prefill: the padded length S
    prompt: int = 0            # prefill: the tokens the prompt holds
    positions: tuple = ()      # decode_step: each live slot's position


class Gate:
    """Holds the model's callers between two calls: ``hold`` returns once
    no call is in flight and a caller waits at the gate (or, the engine
    idle, after ``idle_s``), so nothing launches work on the card until
    ``release``."""

    def __init__(self):
        self._cv = threading.Condition()
        self._closed = False
        self._in_call = 0
        self._parked = 0

    def enter(self) -> None:
        with self._cv:
            while self._closed:
                self._parked += 1
                self._cv.notify_all()
                self._cv.wait()
                self._parked -= 1
            self._in_call += 1

    def leave(self) -> None:
        with self._cv:
            self._in_call -= 1
            self._cv.notify_all()

    def hold(self, idle_s: float = 0.5) -> None:
        with self._cv:
            self._closed = True
            deadline = time.monotonic() + idle_s
            while self._in_call or not self._parked:
                left = deadline - time.monotonic()
                if not self._in_call and left <= 0:
                    break
                self._cv.wait(max(left, 0.05))

    def release(self) -> None:
        with self._cv:
            self._closed = False
            self._cv.notify_all()


class ModelProxy:
    """``engine.model`` with every prefill and decode step recorded, behind
    a ``Gate`` that the profiler's start and stop hold closed: stopped
    under the pollers' launches it crashed a run, started under them it
    lost a run's kernels, and stopped from a poller thread it failed
    (kineto's state is the starting thread's)."""

    def __init__(self, model, engine, sync):
        self._model, self._engine, self._sync = model, engine, sync
        self.calls: list[Call] = []
        self.gate = Gate()

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, params, batch):
        self.gate.enter()
        try:
            t0 = time.time_ns()
            out = self._model.prefill(params, batch)
            self._sync()
            t1 = time.time_ns()
            toks = batch["tokens"]
            # prompt ids are never 0 (traffic.py): the rest of the bucket is padding
            self.calls.append(Call("prefill", t0, t1, bucket=int(toks.shape[1]),
                                   prompt=int(toks[0].count_nonzero())))
        finally:
            self.gate.leave()
        return out

    def decode_step(self, params, tokens, cache, pos):
        self.gate.enter()
        try:
            eng = self._engine
            live = tuple(int(eng.pos[i]) for i, r in enumerate(eng.active) if r is not None)
            t0 = time.time_ns()
            out = self._model.decode_step(params, tokens, cache, pos)
            self._sync()
            self.calls.append(Call("decode_step", t0, time.time_ns(), positions=live))
        finally:
            self.gate.leave()
        return out


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class DeviceSlice:
    """A stretch of the window under ``torch.profiler`` (CUDA activity:
    the device's operations), started and stopped by one thread."""

    start_ns: int = 0
    end_ns: int = 0
    ops: list[DeviceOp] = field(default_factory=list)
    stop_s: float = 0.0           # the profiler's stop, the model's callers held
    read_s: float = 0.0           # the reading of its events, after
    _prof: object = None
    _read: bool = False

    def start(self) -> None:
        """Without CUDA (the CPU tests) the slice records no operation."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA]) if torch.cuda.is_available() \
            else False
        if self._prof:
            self._prof.start()
        self.start_ns = time.time_ns()

    @property
    def started(self) -> bool:
        return self._prof is not None

    @property
    def recorded(self) -> bool:
        """Whether the slice ran and was read."""
        return self._read

    def stop(self) -> None:
        """Stop the profiler (``read`` takes its events)."""
        if self._prof is None or self.end_ns:
            return
        self.end_ns = time.time_ns()
        if self._prof:
            t = time.monotonic()
            self._prof.stop()
            self.stop_s = time.monotonic() - t

    def read(self) -> None:
        """Take the stopped profiler's device operations."""
        from torch.autograd import DeviceType
        if not self.end_ns or self._read:
            return
        self._read = True
        if not self._prof:
            return
        t = time.monotonic()
        self.ops = sorted((DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                           for e in self._prof.profiler.kineto_results.events()
                           if e.device_type() == DeviceType.CUDA),
                          key=lambda op: op.start_ns)
        self.read_s = time.monotonic() - t

    def lost(self, calls: list[Call]) -> bool:
        """Whether the profiler ran and lost the kernels of a model call
        wholly inside the slice (see ``unseen_calls``)."""
        return bool(self._prof) and bool(unseen_calls(self.ops, calls, self.start_ns,
                                                      self.end_ns))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _clip(op_start, op_end, lo, hi) -> tuple[int, int]:
    return max(op_start, lo), min(op_end, hi)


def busy_and_gaps(ops: list[DeviceOp], lo: int, hi: int) -> tuple[int, list[tuple[int, int]]]:
    """(ns in [lo, hi] with an operation running, the idle gaps)."""
    busy, gaps, cursor = 0, [], lo
    for op in ops:
        s, e = _clip(op.start_ns, op.end_ns, lo, hi)
        if e <= s or e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
            busy += e - s
        else:
            busy += e - cursor
        cursor = e
    if cursor < hi:
        gaps.append((cursor, hi))
    return busy, gaps


def unseen_calls(ops: list[DeviceOp], calls: list[Call], lo: int, hi: int) -> list[Call]:
    """The model calls wholly inside [lo, hi] in which no kernel started:
    a call launches kernels and waits for them, so each is a kernel the
    profiler lost (copies and fills alone are what it keeps then)."""
    starts = [op.start_ns for op in ops if not op.name.startswith(COPIES)]
    out = []
    for c in calls:
        if lo <= c.start_ns and c.end_ns <= hi:
            i = bisect.bisect_left(starts, c.start_ns)
            if i == len(starts) or starts[i] >= c.end_ns:
                out.append(c)
    return out


def label_of(t_ns: int, calls: list[Call]) -> str:
    """What the host was doing at ``t_ns``: inside which model call."""
    for c in calls:
        if c.start_ns <= t_ns < c.end_ns:
            return f"Model.{c.kind}"
    return "between model calls"


def breakdown(ops, calls, lo, hi, n: int = 10) -> dict:
    """The device operations that took most time in [lo, hi], and the
    idle time by what the host was doing: each label's total, then the
    longest gaps, at most ``n`` entries each, in seconds."""
    by_name: dict[str, int] = {}
    for op in ops:
        s, e = _clip(op.start_ns, op.end_ns, lo, hi)
        if e > s:
            by_name[op.name] = by_name.get(op.name, 0) + e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    _, gaps = busy_and_gaps(ops, lo, hi)
    labelled = [(label_of((a + b) // 2, calls), b - a) for a, b in gaps]
    totals: dict[str, list] = {}
    for label, ns in labelled:
        t = totals.setdefault(label, [0, 0])
        t[0] += ns
        t[1] += 1
    idle = [[f"{label}: all {cnt} gaps", ns / 1e9]
            for label, (ns, cnt) in sorted(totals.items(), key=lambda kv: -kv[1][0])]
    idle += [[f"{label}: one gap", ns / 1e9]
             for label, ns in sorted(labelled, key=lambda x: -x[1])[:n - len(idle)]]
    return {"device_ops": [[name[:120], ns / 1e9] for name, ns in top], "idle_gaps": idle[:n]}


def k1_share(ops, calls, model: dict, lo: int, hi: int) -> tuple[float, float, int] | None:
    """(K1's least seconds, its device seconds, launches) over the K1
    launches that ran in [lo, hi]: each launch's least time from its
    prefill's shape (B=1, the bucket's S, causal).  None without one."""
    prefills = [c for c in calls if c.kind == "prefill"]
    least = device = 0.0
    count = 0
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    for op in ops:
        if K1_PREFIX not in op.name or not (lo <= op.start_ns < hi):
            continue
        # the prefill it ran in: the last one to start before it
        call = next((c for c in reversed(prefills) if c.start_ns <= op.start_ns), None)
        if call is None:
            continue
        least += roofline.attn_bound_s(1, call.bucket, model["n_heads"], model["n_kv_heads"], hd)
        device += (op.end_ns - op.start_ns) / 1e9
        count += 1
    return (least, device, count) if count else None


def useful_flops(calls: list[Call], model: dict, lo: int, hi: int) -> float:
    """Useful FLOPs of the model calls in [lo, hi] (a call straddling an
    end counts the share of its time inside)."""
    total = 0.0
    for c in calls:
        inside = min(c.end_ns, hi) - max(c.start_ns, lo)
        if inside <= 0:
            continue
        if c.kind == "prefill":
            work = roofline.prefill_flops(model, c.prompt)
        else:
            work = sum(roofline.decode_flops(model, p) for p in c.positions)
        total += work * inside / max(c.end_ns - c.start_ns, 1)
    return total
