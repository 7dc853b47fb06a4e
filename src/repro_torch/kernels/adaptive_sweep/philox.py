"""The Philox contract of the event-jump sweep (S2): the random numbers that
the kernel (``csrc/adaptive_sweep.cu``) and its plain version both draw, bit
for bit, here as plain PyTorch.

Generator, key and transforms are the fixed-slot sweep's
(``kernels/slot_sweep/philox.py``): Philox4x32-10 keyed by the point's 64-bit
seed as (low word, high word), uniforms ``float(w >> 8) * 2^-24``,
exponentials ``-log(1 - u)``, Box-Muller normals on the word pairs (0, 1) and
(2, 3) of a block.

Counter: (step, stream, lane block, 1).  The fourth word is 1 where the
fixed-slot sweep's is 0, so the two sweeps never draw from one counter.  A
lane is a thread or a queue (at most ``MAX_LANES`` = 4 of each), so a lane's
draws do not depend on how many lanes the batch pads to.  One stream per draw
family of the reference's ``one_point``
(``src/repro/runtime/batched_adaptive.py:197``):

  INIT    0  step 0, block 0, word i -> thread i's initial-sleep uniform
             (:213); block 1, word 0 -> the exponential of the first stall
             start, ``next_stall0`` (:217)
  NORMAL  1  the fused arrival + overshoot normals ``zs`` (:235): block 0 ->
             queues 0..3, block 1 -> threads 0..3
  TAIL    2  the sleep-model tail ``kp``, ``ku`` (:229, :374-376): block 0,
             word i -> thread i's hit uniform; block 1, word i -> its
             exponential
  INTF    3  per-wake interference ``kip``, ``kie`` (:231, :378-380): laid
             out as TAIL
  STALL   4  the stall triple (:233): block 0, word 0 -> the window-length
             exponential ``kse`` (:360), word 1 -> the gap exponential ``ksg``
             (:364); block 1, word i -> thread i's re-arm jitter uniform
             ``ksu`` (:396)

The reference's threefry bits are not reproduced; tests hold the plain sweep
to the reference by feeding it the reference's own draws through the
``StepDraws`` interface instead.
"""

from __future__ import annotations

import torch

from ..slot_sweep.philox import MAX_LANES, exponential, lanes, philox4x32_10, uniform

__all__ = ["INIT", "NORMAL", "TAIL", "INTF", "STALL", "COUNTER_WORD3", "StepDraws"]

INIT, NORMAL, TAIL, INTF, STALL = range(5)
COUNTER_WORD3 = 1          # the fixed-slot sweep draws with 0
_MASK = 0xFFFFFFFF


class StepDraws:
    """The draws of the Philox contract for a batch of points, in the form
    the plain event-jump sweep consumes.

    ``seed_lo`` and ``seed_hi`` are integer tensors (P,) of the seeds'
    32-bit words; ``m`` and ``q`` the batch's thread and queue counts (at
    most ``MAX_LANES``); the flags name the families the batch's environment
    draws from.  ``initial()`` gives a dict of ``sleep_u`` (P, m), the
    initial-sleep uniforms, and, with stalls on, ``stall_e`` (P,), the first
    stall start's exponential; ``chunk(t0, t1)`` the steps [t0, t1) as a dict
    of float32 tensors with the step first: ``z_q`` (T, P, q) and, where
    drawn, ``z_m``, ``tail_u``, ``tail_e``, ``intf_u``, ``intf_e``,
    ``stall_jitter`` (T, P, m), ``stall_len_e`` and ``stall_gap_e`` (T, P).
    Any object with these two methods can stand in (the tests feed the
    reference's own draws that way)."""

    def __init__(self, seed_lo: torch.Tensor, seed_hi: torch.Tensor, *, m: int, q: int,
                 sigma: bool, tail: bool, intf: bool, stall: bool):
        if not (1 <= m <= MAX_LANES and 1 <= q <= MAX_LANES):
            raise ValueError(f"m={m} and q={q} must lie in 1..{MAX_LANES}")
        self.k0 = seed_lo.to(torch.int64) & _MASK
        self.k1 = seed_hi.to(torch.int64) & _MASK
        self.m, self.q = m, q
        self.sigma, self.tail, self.intf, self.stall = sigma, tail, intf, stall

    def _block(self, steps: torch.Tensor, stream: int, block: int):
        # steps (T, 1) x keys (1, P) -> four (T, P) words
        return philox4x32_10(steps, stream, block, COUNTER_WORD3, self.k0[None, :],
                             self.k1[None, :])

    def initial(self) -> dict[str, torch.Tensor]:
        zero = torch.zeros((1, 1), dtype=torch.int64, device=self.k0.device)
        out = {"sleep_u": lanes(self._block(zero, INIT, 0), "u", self.m)[0]}
        if self.stall:
            out["stall_e"] = exponential(uniform(self._block(zero, INIT, 1)[0]))[0]
        return out

    def chunk(self, t0: int, t1: int) -> dict[str, torch.Tensor]:
        steps = torch.arange(t0, t1, dtype=torch.int64, device=self.k0.device)[:, None]
        out = {"z_q": lanes(self._block(steps, NORMAL, 0), "z", self.q)}
        if self.sigma:
            out["z_m"] = lanes(self._block(steps, NORMAL, 1), "z", self.m)
        for flag, stream, name in ((self.tail, TAIL, "tail"), (self.intf, INTF, "intf")):
            if flag:
                out[f"{name}_u"] = lanes(self._block(steps, stream, 0), "u", self.m)
                out[f"{name}_e"] = lanes(self._block(steps, stream, 1), "e", self.m)
        if self.stall:
            w = self._block(steps, STALL, 0)
            out["stall_len_e"] = exponential(uniform(w[0]))
            out["stall_gap_e"] = exponential(uniform(w[1]))
            out["stall_jitter"] = lanes(self._block(steps, STALL, 1), "u", self.m)
        return out
