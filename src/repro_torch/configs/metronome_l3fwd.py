"""The paper's own evaluated configuration (Sec 5): the l3fwd testbed.

Not a neural architecture — the Metronome serving/retrieval config the
paper tunes and measures.  Exposed here as the canonical parameter set the
benchmarks and simulator default to, with the paper's tuning rationale.
"""

from repro_torch.core import MetronomeConfig
from repro_torch.core.simulator import HR_SLEEP_MODEL, SimConfig

# Sec 5 defaults: V-bar = 10us (first no-loss point, Table 2),
# T_L = 500us (>= 50x max T_S; Fig 7 knee), M = 3 (Fig 8/9: more threads
# waste wakeups and hurt tail latency), 1024-descriptor Rx ring.
PAPER_CONFIG = MetronomeConfig(
    m=3,
    v_target_us=10.0,
    t_long_us=500.0,
    alpha=0.125,
)

# 10GbE worst case: 64B packets = 14.88 Mpps; drain rate ~2x line rate
# (consistent with the paper's measured B ~= V at line rate, Table 2).
PAPER_SIM = SimConfig(
    m=PAPER_CONFIG.m,
    arrival_rate_mpps=14.88,
    service_rate_mpps=29.76,
    queue_capacity=1024,
    v_target_us=PAPER_CONFIG.v_target_us,
    t_long_us=PAPER_CONFIG.t_long_us,
    alpha=PAPER_CONFIG.alpha,
    adaptive=True,
    sleep_model=HR_SLEEP_MODEL,
)
