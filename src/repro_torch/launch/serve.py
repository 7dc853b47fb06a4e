"""Serving launcher CLI — Metronome retrieval in front of the
continuous-batching engine (PyTorch port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \
      --requests 20 --rate 40 [--device cpu]

Drives a Poisson request load and reports the paper's metrics (host CPU
fraction, TTFT, retrieval latency) for Metronome vs the busy-poll
baseline.  Runs on CUDA unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core import MetronomeConfig
from repro_torch.models import Model
from repro_torch.runtime import BusyPollPolicy, FixedPeriodPolicy, MetronomePolicy
from repro_torch.serving import EngineConfig, InferenceEngine, Request, Server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--pollers", type=int, default=3)
    ap.add_argument("--v-target-us", type=float, default=3_000.0)
    ap.add_argument("--policy", default="metronome",
                    choices=("metronome", "busy-poll", "fixed-period"),
                    help="retrieval policy (repro_torch.runtime)")
    ap.add_argument("--busy-poll", action="store_true",
                    help="deprecated alias for --policy busy-poll")
    ap.add_argument("--device", default="cuda",
                    help="torch device for parameters and caches (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    engine = InferenceEngine(model, params,
                             EngineConfig(max_slots=args.slots,
                                          max_len=args.max_len,
                                          prefill_buckets=(8, 16)))
    warm = Request(prompt=[1, 2], max_new_tokens=2)
    engine.submit([warm])
    engine.pump()

    if args.busy_poll and args.policy != "metronome":
        ap.error("--busy-poll (deprecated) conflicts with an explicit "
                 "--policy; pass --policy busy-poll instead")
    mode = "busy-poll" if args.busy_poll else args.policy
    if mode == "busy-poll":
        policy = BusyPollPolicy()
    elif mode == "fixed-period":
        policy = FixedPeriodPolicy(args.v_target_us, threads=1)
    else:
        policy = MetronomePolicy(
            MetronomeConfig(m=args.pollers, v_target_us=args.v_target_us,
                            t_long_us=args.v_target_us * 20))
    server = Server(engine, policy)
    server.start()
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        r = Request(prompt=[(i % (cfg.vocab_size - 3)) + 1, 2, 3],
                    max_new_tokens=args.max_new)
        server.submit(r)
        reqs.append(r)
        time.sleep(rng.exponential(1.0 / args.rate))
    ok = all(r.wait(60.0) for r in reqs)
    stats = server.stop()
    ttft = np.median([(r.first_token_ns - r.arrival_ns) / 1e6 for r in reqs])
    print(f"arch={cfg.name} mode={mode} device={model.device} "
          f"completed={sum(len(r.tokens) == args.max_new for r in reqs)}/{len(reqs)} "
          f"cpu={stats.cpu_fraction:.3f} ttft_ms={ttft:.2f}")
    if mode == "metronome":
        ctrl = policy.controller
        print(f"controller: rho={ctrl.rho:.3f} T_S={ctrl.t_short_us:.0f}us "
              f"cycles={ctrl.cycles}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
