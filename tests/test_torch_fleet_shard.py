"""``simulate_fleet``'s point split across devices (``runtime.fleet.
split_sweep``, the counterpart of the reference's ``shard_map`` over a
``("pts",)`` mesh, ``src/repro/runtime/fleet.py:797-808, 1063-1081``), on
the CPU: three "devices" that are all the CPU, the plain fleet sweeps.

- ``split_sweep`` over ``[cpu] * 3`` of 5 points (padded to 6 by repeating
  row 0) of 2 hosts, 2 ms of simulated time with interference and stalls,
  equals one unsplit call bit for bit, for S3 (fixed slots) and S3b (event
  jumps); so does ``simulate_fleet`` routed through it, whose ``backend``
  names the 3 shards; the event-jump budget is the whole grid's.
- The helper's contract: the padding rows are row 0, every shard gets the
  whole batch's maxima of m and n_queues (its kernel build, and no read
  back from the device), and every shard is launched before any result is
  read.
- With one device, or ``shard=False``, one shard: ``simulate_fleet`` on
  the CPU makes one call of the sweep, as on one card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.fleet_adaptive_sweep import fleet_adaptive_sweep
from repro_torch.kernels.fleet_sweep import fleet_sweep
from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig, StepSchedule
from repro_torch.runtime import fleet as fleet_mod
from repro_torch.runtime.fleet import (
    fleet_adaptive_inputs,
    fleet_inputs,
    simulate_fleet,
    split_sweep,
)

CPU = torch.device("cpu")
MU = 29.76
SLOT_US = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    """5 points of 2 hosts: mixed m and n_queues (so the whole batch's
    maxima are not every shard's), hedged and not, one on a schedule."""
    pts = [dict(t_s_us=8.0, t_l_us=300.0, m=1, n_queues=1, rate_mpps=0.5 * MU, seed=0),
           dict(t_s_us=20.0, t_l_us=500.0, m=4, n_queues=4, rate_mpps=0.9 * MU, seed=1,
                hedge_deadline_us=20.0),
           dict(t_s_us=5.0, t_l_us=150.0, m=2, n_queues=3, rate_mpps=0.3 * MU, seed=2,
                schedule=StepSchedule(times_us=(0.0, 900.0), scales=(0.5, 1.6))),
           dict(t_s_us=12.0, t_l_us=400.0, m=3, n_queues=2, rate_mpps=0.7 * MU, seed=3,
                hedge_deadline_us=40.0),
           dict(t_s_us=30.0, t_l_us=600.0, m=1, n_queues=1, rate_mpps=0.6 * MU, seed=4)]
    fgrid = FleetGrid.of_points(pts, fleet=FleetConfig(n_hosts=2))
    cfg = SimRunConfig(duration_us=2000.0, interference_prob=0.2, interference_mean_us=15.0,
                       stall_rate_per_us=2.5e-4, stall_mean_us=150.0)
    return fgrid, cfg


STEPPINGS = {"fixed": (fleet_inputs, fleet_sweep),
             "adaptive": (fleet_adaptive_inputs, fleet_adaptive_sweep)}


def _assert_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), (k, (a[k] - b[k]).abs().max())


@pytest.fixture(scope="module")
def unsplit():
    """Each stepping's one unsplit call on the grid: (args, params, fleet
    params, outputs)."""
    fgrid, cfg = _grid()
    out = {}
    for stepping, (inputs, sweep) in STEPPINGS.items():
        args, params, fparams = inputs(fgrid, cfg, SLOT_US, CPU)
        out[stepping] = args, params, fparams, sweep(*args, params=params, fleet=fparams)
    return out


@pytest.mark.parametrize("stepping", list(STEPPINGS))
def test_split_over_three_devices_equals_one_call(unsplit, stepping):
    args, params, fparams, want = unsplit[stepping]
    got = split_sweep(STEPPINGS[stepping][1], args, [CPU] * 3, params=params, fleet=fparams)
    assert got["wakeups"].shape == (5, 2)
    _assert_equal(got, want)


@pytest.mark.parametrize("stepping", list(STEPPINGS))
def test_simulate_fleet_split_names_its_shards_and_equals_unsplit(monkeypatch, stepping):
    fgrid, cfg = _grid()
    one = simulate_fleet(fgrid, cfg, stepping=stepping, device="cpu")
    assert one.backend == "plain"
    monkeypatch.setattr(fleet_mod, "_shard_devices", lambda device, n_pts, shard: [CPU] * 3)
    three = simulate_fleet(fgrid, cfg, stepping=stepping, device="cpu")
    assert three.backend == "plain x 3 shards"
    assert three.scan_len == one.scan_len          # the whole grid's budget / slot count
    for k in ("offered", "dropped", "serviced", "wakeups", "busy_tries", "cycles",
              "awake_us", "lat_area", "energy_uj", "topo_area", "hedge_dup", "n_steps",
              "forced_steps", "sim_time_us"):
        np.testing.assert_array_equal(getattr(three, k), getattr(one, k), err_msg=k)


def test_split_pads_with_row_zero_and_queues_every_shard_first(unsplit):
    """A recording stand-in for the sweep: 3 shards of 2 rows (the last
    row of the third is row 0), each with the whole batch's (m_max,
    q_max) and called before any output is read."""
    args, params, fparams, _ = unsplit["fixed"]
    calls, reads = [], []

    class Out(dict):
        def __getitem__(self, k):
            reads.append(len(calls))
            return dict.__getitem__(self, k)

    def sweep(*cols, params, fleet, bounds):
        calls.append((cols, bounds))
        assert not reads, "a result was read before every shard was launched"
        return Out(t_s=cols[0].clone())

    got = split_sweep(sweep, args, [CPU] * 3, params=params, fleet=fparams)
    assert len(calls) == 3
    assert all(b == (4, 4) for _, b in calls)
    assert [c[0].shape[0] for c, _ in calls] == [2, 2, 2]
    assert torch.equal(calls[2][0][0][1], args[0][0])           # the padding is row 0
    assert torch.equal(got["t_s"], args[0])                       # cut back to 5, in order


@pytest.mark.parametrize("shard", [None, False, True])
def test_one_device_is_one_launch(monkeypatch, shard):
    """On the CPU (one device) and with ``shard=False``: one call of the
    sweep over every point, and no split."""
    fgrid, cfg = _grid()
    calls = []
    real = fleet_mod.fleet_sweep

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(fleet_mod, "fleet_sweep", counting)
    st = simulate_fleet(fgrid, dataclasses.replace(cfg, duration_us=200.0), shard=shard,
                        device="cpu")
    assert calls == [5] and st.backend == "plain"
    assert fleet_mod._shard_devices(CPU, 5, shard) == [CPU]
