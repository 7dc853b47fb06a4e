"""Drive a served model with one traffic mix (a mix's ``"driver": "serve"``).

Every request enters through the system's normal path: ``Server.submit``
under the mix's ``MetronomePolicy``, then ``InferenceEngine.pump``, then
``Model.prefill`` (``attn="kernel"``: K1) and ``Model.decode_step``.

Set-up builds the model from the configuration file, draws its weights
from the seed on the device, builds the engine, warms each bucket that the
mix's prompts reach and its decode batch, and (an offline batch) queues
the backlog.  The window then runs for ``seconds``: an open loop submits
each request when it is due and stamps it with that time; a backlog
submits one more request for each completion.  After the window the open
loop's requests are awaited; a backlog's requests not yet admitted are
dropped and its admitted ones end at their next token.  The server is then
stopped and its pollers joined, and the check runs on the freed card.  A
traced run whose profiled slice lost the kernels of a model call serves
the window once more under a fresh profiler; its numbers are the second
window's, and the check holds the answers of both.
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gpu_bench.bench import check, spec
from gpu_bench.bench.trace import DeviceSlice, ModelProxy
from gpu_bench.bench.traffic import Traffic
from gpu_bench.bench.weights import Redraw, build_params

__all__ = ["Record", "Run", "Session", "Window", "run", "WAIT_S"]

WAIT_S = 60.0            # how long past the window a due answer is awaited
POLL_S = 0.005           # the backlog's look for completions
SLICE_S = 6.0            # the traced run's profiled slice: the window's last seconds


@dataclass
class Record:
    """One request as the window saw it (monotonic ns; 0: never)."""

    prompt: np.ndarray
    max_new: int
    due_ns: int = 0
    first_token_ns: int = 0
    done_ns: int = 0
    tokens: tuple = ()


@dataclass
class Run:
    """Everything a metric's reader may read: the set-up, the window, the
    memory peak and the check."""

    cell: str
    model: dict                   # the configuration's ``ModelConfig`` fields
    setup_s: float
    window: "Window"
    memory_peak_bytes: int
    checks: list = field(default_factory=list)
    check_s: float = 0.0          # the reference's comparison
    earlier: list = field(default_factory=list)   # windows whose slice lost kernels

    @property
    def correct(self) -> bool:
        return self.window.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


def _sync(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def _warm(engine, vocab: int, buckets) -> None:
    """One request a bucket through the engine: each prefill shape, the
    decode batch, and the kernels' first load."""
    from repro_torch.serving import Request
    for b in buckets:
        engine.submit([Request(prompt=[1 + i % (vocab - 1) for i in range(b)], max_new_tokens=2)])
    engine.pump()


def _reached(buckets, sizes) -> list[int]:
    """The buckets that prompts of ``sizes`` fill (the engine keeps a
    prompt's last ``buckets[-1]`` tokens, in the least bucket that holds
    them)."""
    return sorted({next(b for b in buckets if min(n, buckets[-1]) <= b) for n in sizes})


def _drop_unadmitted(server, engine) -> None:
    """End a backlog after its window: its queued requests are dropped,
    and those the engine took but has not admitted, all but the one its
    pump may be taking (``del`` of a slice is one step under the GIL, and
    ``pump`` alone pops, after a look that the list is not empty)."""
    for q in server.queues:
        q.poll(len(q))          # a popleft each, safe beside a poller's poll
    del engine.pending[1:]


@dataclass
class Window:
    """What one window of a session saw."""

    start_ns: int
    end_ns: int
    tokens: int                   # output tokens produced inside the window
    records: list[Record]
    open_loop: bool
    stats: object
    gave_up_ns: int               # when the awaiting after the window ended
    late_ns: int                  # how late the open loop's feeder ran at most
    calls: list                   # trace.Call, traced runs
    device_slice: DeviceSlice | None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def due(self) -> list[Record]:
        """An open loop's requests due in the window."""
        return self.records if self.open_loop else []

    @property
    def attempted(self) -> int:
        return len(self.records) if self.open_loop else len(self._in_window)

    @property
    def _in_window(self) -> list[Record]:
        return [r for r in self.records if r.first_token_ns and r.first_token_ns <= self.end_ns]

    @property
    def failed(self) -> int:
        pool = self.records if self.open_loop else self._in_window
        return sum(1 for r in pool if r.due_ns < 0 or not r.done_ns)

    @property
    def finished(self) -> list[Record]:
        """The requests whose answers the check may read: an open loop's
        finished ones, a backlog's finished inside the window."""
        if self.open_loop:
            return [r for r in self.records if r.done_ns and r.due_ns >= 0]
        return [r for r in self.records if r.done_ns and r.done_ns <= self.end_ns]


class Session:
    """One cell's program under one seed: built and warmed (set-up), then
    driven for one or more windows, then freed."""

    def __init__(self, cell: spec.Cell, seed: int, *, device="cuda", trace: bool = False,
                 plant=None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import Model
        from repro_torch.serving import EngineConfig, InferenceEngine

        self.cell, self.seed, self.device = cell, seed, device
        self.model_dict, self.mix = cell.config["model"], cell.mix
        name = cell.config["reference"]
        self.reference = spec.load_module(spec.BENCH_DIR / "reference" / f"{name}.py",
                                          f"gpu_bench_reference_{name}")
        self.specs = self.reference.leaf_specs(self.model_dict)
        self.cfg = ModelConfig(**self.model_dict)
        self.sync = _sync(device)
        self.cuda = torch.device(device).type == "cuda"
        eng = self.mix["engine"]
        self.model = Model(self.cfg, attn="kernel", device=device)
        self.params = build_params(self.specs, seed, self.cfg.n_layers, device)
        self.engine = InferenceEngine(self.model, self.params, EngineConfig(
            max_slots=eng["max_slots"], max_len=eng["max_len"],
            prefill_buckets=tuple(eng["prefill_buckets"])))
        sizes = Traffic(self.mix, seed, self.cfg.vocab_size).prompt_sizes()
        _warm(self.engine, self.cfg.vocab_size, _reached(eng["prefill_buckets"], sizes))
        self.sync()
        self.proxy = None
        if trace:
            # the profiler's first start is slow: a throwaway one in set-up
            warm = DeviceSlice()
            warm.start()
            torch.zeros(1, device=device).add_(1)
            self.sync()
            warm.stop()
            self.proxy = ModelProxy(self.model, self.engine, self.sync)
            self.engine.model = self.proxy
        if plant is not None:
            plant(self.engine)

    def window(self, seconds: float, *, mix: dict | None = None) -> Window:
        """Serve ``mix`` (default the cell's) for ``seconds``, then await
        or cut short what is left and stop the server."""
        from repro_torch.core import MetronomeConfig
        from repro_torch.runtime import MetronomePolicy
        from repro_torch.serving import Request, Server

        mix = mix or self.mix
        traffic = Traffic(mix, self.seed, self.cfg.vocab_size)
        server = Server(self.engine, MetronomePolicy(MetronomeConfig(**mix["policy"])))
        calls_before = len(self.proxy.calls) if self.proxy is not None else 0

        def request(plan):
            return plan, Request(prompt=plan.prompt.tolist(), max_new_tokens=plan.max_new)

        window = [request(p) for p in traffic.window(seconds)] if traffic.open_loop else []
        submitted = []
        if not traffic.open_loop:              # the backlog's fill is set-up
            submitted = [request(traffic.plan(k))
                         for k in range(mix["arrivals"]["depth"])]
            for _, r in submitted:
                server.submit(r)
        device_slice = DeviceSlice() if self.proxy is not None else None
        server.start()
        t0 = time.monotonic_ns()
        t_end = t0 + int(seconds * 1e9)
        # the traced slice: the window's last SLICE_S seconds
        slice_at = max(t_end - int(SLICE_S * 1e9), t0)
        nxt, late_ns = 0, 0
        while True:
            now = time.monotonic_ns()
            if device_slice is not None and not device_slice.started and now >= slice_at:
                self._with_callers_held(device_slice.start)
            if traffic.open_loop:
                while nxt < len(window) and t0 + int(window[nxt][0].due_s * 1e9) <= now:
                    plan, r = window[nxt]
                    r.arrival_ns = t0 + int(plan.due_s * 1e9)
                    late_ns = max(late_ns, now - r.arrival_ns)
                    if not server.submit(r):
                        r.arrival_ns = -1          # refused at the door: failed
                    nxt += 1
                wake = t0 + int(window[nxt][0].due_s * 1e9) if nxt < len(window) else t_end
            if now >= t_end:
                break
            if not traffic.open_loop:
                done = sum(r._done.is_set() for _, r in submitted)
                while len(submitted) - done < mix["arrivals"]["depth"]:
                    pr = request(traffic.plan(len(submitted)))
                    submitted.append(pr)
                    server.submit(pr[1])
                wake = now + int(POLL_S * 1e9)
            if device_slice is not None and not device_slice.started and slice_at > now:
                wake = min(wake, slice_at)
            time.sleep(max(min(wake, t_end) - time.monotonic_ns(), 0) / 1e9)
        pairs = window[:nxt] if traffic.open_loop else submitted
        tokens = sum(len(r.tokens) for _, r in pairs)
        t1 = time.monotonic_ns()
        if device_slice is not None and device_slice.started:
            self._with_callers_held(device_slice.stop)
            device_slice.read()

        # after the window: an open loop's answers are awaited; a backlog's
        # admitted requests end at their next token and the rest are dropped
        # (one the engine is admitting keeps one prompt token), and stopping
        # the server waits for the pump to go idle
        if traffic.open_loop:
            deadline = time.monotonic() + WAIT_S
            for _, r in pairs:
                r.wait(max(deadline - time.monotonic(), 0.0))
        else:
            for _, r in pairs:
                if not r._done.is_set():
                    if not r.tokens:
                        r.prompt = r.prompt[:1]
                    r.max_new_tokens = max(len(r.tokens), 1)
            _drop_unadmitted(server, self.engine)
        gave_up_ns = time.monotonic_ns()
        stats = server.stop(timeout=WAIT_S)
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("runtime-") and t.is_alive()]
        if alive:
            raise RuntimeError(f"pollers still running after Server.stop: {alive}")
        records = [Record(prompt=plan.prompt, max_new=plan.max_new,
                          due_ns=r.arrival_ns if traffic.open_loop else 0,
                          first_token_ns=r.first_token_ns, done_ns=r.done_ns,
                          tokens=tuple(r.tokens)) for plan, r in pairs]
        calls = list(self.proxy.calls[calls_before:]) if self.proxy is not None else []
        return Window(start_ns=t0, end_ns=t1, tokens=tokens, records=records,
                      open_loop=traffic.open_loop, stats=stats, gave_up_ns=gave_up_ns,
                      late_ns=late_ns, calls=calls, device_slice=device_slice)

    def _with_callers_held(self, fn) -> None:
        """``fn()`` with the model's callers held between two calls and the
        card idle, so nothing launches or runs while the profiler starts or
        stops."""
        self.proxy.gate.hold()
        try:
            self.sync()
            fn()
        finally:
            self.proxy.gate.release()

    def free(self) -> None:
        """Drop the program's state (weights, cache, engine)."""
        self.engine = self.model = self.params = self.proxy = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def gaps(self, finished: list[Record], *, control: bool = False) -> dict[str, np.ndarray]:
        """The check's normalised gaps over a sample of ``finished``, on
        the freed card."""
        chosen = check.sample([check.Served(r.prompt, r.tokens) for r in finished],
                              int(self.mix["check"]["requests"]), self.seed)
        return check.gaps(self.reference, self.model_dict,
                          Redraw(self.specs, self.seed, self.device), chosen, self.device,
                          control=control)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_start: float, plant=None) -> Run:
    """One run of ``cell``; ``t_start`` is the process's start (monotonic
    s).  ``plant(engine)``, for tests, breaks the timed path underneath."""
    session = Session(cell, seed, device=device, trace=trace, plant=plant)
    windows = [session.window(seconds)]
    if windows[0].device_slice is not None and windows[0].device_slice.lost(windows[0].calls):
        # the profiler lost kernels of a model call in the slice: the window
        # once more, under a fresh profiler, for the numbers; the check
        # holds both windows' answers
        windows.append(session.window(seconds))
    w, earlier = windows[-1], windows[:-1]
    memory_peak = torch.cuda.max_memory_allocated() if session.cuda else 0
    session.free()
    t_check = time.monotonic()
    vocab = session.cfg.vocab_size
    checks = [check.Check("tokens_outside_vocab",
                          float(sum(1 for x in windows for r in x.records for t in r.tokens
                                    if not 0 <= t < vocab)), 0.0),
              # a run that finished no request has nothing to compare, and fails
              check.Check("requests_unfinished", float(not w.finished), 0.0)]
    if earlier:
        checks.append(check.Check("earlier_window_failed", float(sum(x.failed for x in earlier)),
                                  0.0))
    finished = [r for x in windows for r in x.finished]
    if w.finished:
        g = session.gaps(finished)["program"]
        checks += [check.Check(name, float(check.STATISTICS[name](g)), float(limit))
                   for name, limit in cell.limits.items()]
    return Run(cell=cell.name, model=session.model_dict,
               setup_s=windows[0].start_ns / 1e9 - t_start, window=w,
               memory_peak_bytes=int(memory_peak), checks=checks,
               check_s=time.monotonic() - t_check, earlier=earlier)
