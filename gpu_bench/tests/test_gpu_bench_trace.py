"""The traced run's reductions on a trace made by hand."""

import pytest

import gpu_bench_toy  # noqa: F401

from gpu_bench.bench import roofline
from gpu_bench.bench.trace import (Call, DeviceOp, breakdown, busy_and_gaps, k1_share,
                                   label_of, unseen_calls, useful_flops)

OPS = [DeviceOp("gemm", 0, 10), DeviceOp("copy", 5, 15),
       DeviceOp("flash_fwd_pingpong_bf16", 20, 30)]
CALLS = [Call("prefill", 0, 18, bucket=1024, prompt=1000), Call("decode_step", 18, 35,
                                                                positions=(5, 9))]
MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
         "vocab_size": 100, "mlp_type": "swiglu"}


def test_busy_and_gaps():
    busy, gaps = busy_and_gaps(OPS, 0, 40)
    assert busy == 25 and gaps == [(15, 20), (30, 40)]
    busy, gaps = busy_and_gaps(OPS, 8, 25)                     # clipped to the slice
    assert busy == 7 + 5 and gaps == [(15, 20)]


def test_gaps_are_labelled_by_the_host_call():
    assert label_of(17, CALLS) == "Model.prefill"
    assert label_of(20, CALLS) == "Model.decode_step"
    assert label_of(35, CALLS) == "between model calls"
    b = breakdown(OPS, CALLS, 0, 40)
    assert b["device_ops"][0] == ["gemm", 1e-8] and len(b["device_ops"]) == 3
    assert ["Model.prefill: all 1 gaps", 5e-9] in b["idle_gaps"]
    assert ["between model calls: all 1 gaps", 1e-8] in b["idle_gaps"]


def test_k1_share_from_each_launch_shape():
    calls = [Call("prefill", 15, 40, bucket=1024, prompt=900)]
    least, device, count = k1_share(OPS, calls, MODEL, 0, 40)
    assert count == 1 and device == pytest.approx(1e-8)
    assert least == pytest.approx(roofline.attn_bound_s(1, 1024, 4, 2, 16))
    assert k1_share(OPS[:2], calls, MODEL, 0, 40) is None


def test_useful_flops_count_the_share_inside():
    whole = useful_flops(CALLS, MODEL, 0, 40)
    want = (roofline.prefill_flops(MODEL, 1000) + roofline.decode_flops(MODEL, 5)
            + roofline.decode_flops(MODEL, 9))
    assert whole == pytest.approx(want)
    half = useful_flops(CALLS[:1], MODEL, 9, 40)
    assert half == pytest.approx(roofline.prefill_flops(MODEL, 1000) / 2)


def test_gate_holds_callers_between_calls():
    """``hold`` returns with no call in flight and a caller parked; the
    caller goes on after ``release``."""
    import threading
    import time

    from gpu_bench.bench.trace import Gate

    gate, log = Gate(), []

    def caller():
        for i in range(3):
            gate.enter()
            log.append(("in", i))
            time.sleep(0.05)
            log.append(("out", i))
            gate.leave()

    t = threading.Thread(target=caller)
    t.start()
    time.sleep(0.02)
    gate.hold(idle_s=2.0)
    held = list(log)
    assert held and held[-1][0] == "out"           # no call in flight
    time.sleep(0.1)
    assert log == held                              # nobody got through
    gate.release()
    t.join(5.0)
    assert not t.is_alive() and log[-1] == ("out", 2)
    gate.hold(idle_s=0.05)                          # an idle engine: returns after idle_s
    gate.release()


def test_unseen_calls_are_the_calls_without_a_kernel():
    assert unseen_calls(OPS, CALLS, 0, 40) == []
    copies = [DeviceOp("Memcpy HtoD (Pageable -> Device)", 1, 2), DeviceOp("Memset (Device)", 20, 21)]
    assert unseen_calls(copies, CALLS, 0, 40) == CALLS
    assert unseen_calls(OPS[:2], CALLS, 0, 40) == [CALLS[1]]
    assert unseen_calls(copies, CALLS, 1, 40) == [CALLS[1]]          # only calls wholly inside



@pytest.mark.parametrize("lost_in", [(), (0,), (0, 1)])
def test_a_window_whose_slice_lost_kernels_is_served_again(monkeypatch, lost_in):
    """A toy traced run whose profiled slices are marked lost in the
    windows ``lost_in``: a first window that lost kernels is served once
    more, and only once; the numbers are the last window's, the check holds
    the answers of both."""
    from gpu_bench_toy import toy_cell

    from gpu_bench.bench import trace
    from gpu_bench.drivers import serve
    from gpu_bench.run import report, result

    slices = []

    def lost(self, calls):
        if not any(x is self for x in slices):
            slices.append(self)
        return next(i for i, x in enumerate(slices) if x is self) in lost_in

    monkeypatch.setattr(trace.DeviceSlice, "lost", lost)
    cell = toy_cell("granite-3-8b.chat_batch")
    run = serve.run(cell, 9, 0.5, True, device="cpu", t_start=0.0)
    windows = 1 + bool(lost_in)
    assert len(slices) == 1 and len(run.earlier) == windows - 1 and run.correct
    assert (run.window.device_slice is slices[0]) == (not lost_in)
    assert [x.device_slice for x in run.earlier] == slices[:windows - 1]
    names = [c.name for c in run.checks]
    assert ("earlier_window_failed" in names) == bool(lost_in)
    assert run.setup_s == (run.earlier or [run.window])[0].start_ns / 1e9
    out = result(cell, run, True, {"platform": "gpu"})
    assert set(out["checks"]) == set(names)
    assert ("an earlier window's slice" in report(cell, 9, run)) == bool(lost_in)
