"""The Philox contract of the fixed-slot sweep: the random numbers that the
kernel (``csrc/slot_sweep.cu``) and its plain version both draw, bit for
bit, here as plain PyTorch.

Generator: Philox4x32-10 (Salmon et al., SC'11; Random123's
``philox4x32_10``).  A round maps counter (c0, c1, c2, c3) under key
(k0, k1) to

    (hi(M1 * c2) ^ c1 ^ k0,  lo(M1 * c2),  hi(M0 * c0) ^ c3 ^ k1,  lo(M0 * c0))

with M0 = 0xD2511F53 and M1 = 0xCD9E8D57; ten rounds, the key bumped by
(0x9E3779B9, 0xBB67AE85) before each round after the first.

Key: the point's 64-bit seed as (low word, high word).  It is the seed and
not the point's index, so points that share a seed share their noise
(common random numbers: neighbouring points of a sweep differ by their
knobs, not by their draws), as the reference folds only the seed into its
key.

Counter: (slot, stream, lane block, 0).  A block gives four 32-bit words
w0..w3, one per lane; a point has at most ``MAX_LANES`` = 4 threads and 4
queues, so a lane's draws do not depend on how many lanes the batch pads
to.  One stream per draw family of the reference's ``one_point``
(``src/repro/runtime/batched.py``):

  INIT    0  initial sleeps (:561): slot 0, block 0, word i -> thread i
  NORMAL  1  the fused arrival + overshoot normals (:581): block 0 ->
             queues 0..3, block 1 -> threads 0..3
  TAIL    2  sleep-model tail (:617-619): block 0, word i -> thread i's hit
             uniform; block 1, word i -> its exponential
  INTF    3  per-wake interference (:626-628): laid out as TAIL
  STALL   4  stall windows (:587-588, :644): block 0, word 0 -> the start
             uniform, word 1 -> the length exponential; block 1, word i ->
             thread i's re-arm jitter uniform

Transforms, all float32 (the kernel makes the same operations):

  uniform      u = float(w >> 8) * 2^-24              in [0, 1), exact
  exponential  e = -log(1 - u)                        (1 - u is exact)
  normal       lanes 2p and 2p + 1 from words 2p and 2p + 1 (Box-Muller):
               r = sqrt(-2 * log(1 - u(w_2p))),  th = f32(2 pi) * u(w_2p+1),
               z_2p = r * cos(th),  z_2p+1 = r * sin(th)

The reference's threefry bits are not reproduced; tests hold the plain
sweep to the reference by feeding it the reference's own draws through the
``SlotDraws`` interface instead.

Torch has no unsigned 64-bit product, and a 32 x 32-bit product overflows
its signed int64 (0xD2511F53 * 0xFFFFFFFF > 2^63), so ``philox4x32_10``
multiplies by each constant in two 16-bit limbs.  Being counter-based, it
draws a whole chunk of slots in one vectorised call.
"""

from __future__ import annotations

import math

import torch

__all__ = ["INIT", "NORMAL", "TAIL", "INTF", "STALL", "MAX_LANES", "TWO_PI_F32",
           "philox4x32_10", "uniform", "exponential", "box_muller", "lanes", "SlotDraws"]

INIT, NORMAL, TAIL, INTF, STALL = range(5)
MAX_LANES = 4

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` < 2^32 and a
    constant ``m`` < 2^32, in 16-bit limbs of ``m`` (no partial product
    reaches 2^49)."""
    p0 = a * (m & 0xFFFF)
    p1 = a * (m >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & _MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of counter (c0..c3) under key (k0, k1): int64 tensors
    or ints holding 32-bit words, broadcast together -> four int64 tensors
    of 32-bit words."""
    args = (c0, c1, c2, c3, k0, k1)
    device = next((x.device for x in args if isinstance(x, torch.Tensor)), None)
    c0, c1, c2, c3, k0, k1 = torch.broadcast_tensors(*(
        torch.as_tensor(x, dtype=torch.int64, device=device) for x in args))
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(w: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a word -> float32 in [0, 1)."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def exponential(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(1.0 - u)


def box_muller(ua: torch.Tensor, ub: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r = torch.sqrt(-2.0 * torch.log(1.0 - ua))
    th = TWO_PI_F32 * ub
    return r * torch.cos(th), r * torch.sin(th)


def lanes(words, kind: str, n: int) -> torch.Tensor:
    """The first ``n`` lanes of one block's four words (each shaped
    ``(...)``) as a float32 tensor ``(..., n)``: ``"u"`` uniforms, ``"e"``
    exponentials, ``"z"`` Box-Muller normals."""
    if kind == "z":
        vals = ()
        for p in range((n + 1) // 2):
            vals += box_muller(uniform(words[2 * p]), uniform(words[2 * p + 1]))
    else:
        vals = tuple(uniform(w) for w in words[:n])
        if kind == "e":
            vals = tuple(exponential(u) for u in vals)
    return torch.stack(vals[:n], dim=-1)


class SlotDraws:
    """The draws of the Philox contract for a batch of points, in the form
    the plain sweep consumes.

    ``seed_lo`` and ``seed_hi`` are integer tensors (P,) of the seeds'
    32-bit words; ``m`` and ``q`` the batch's thread and queue counts (at
    most ``MAX_LANES``); the flags name the families the batch's
    environment draws from.  ``initial()`` gives the (P, m) initial-sleep
    uniforms; ``chunk(t0, t1)`` the slots [t0, t1) as a dict of float32
    tensors with the slot first: ``z_q`` (T, P, q) and, where drawn,
    ``z_m``, ``tail_u``, ``tail_e``, ``intf_u``, ``intf_e``,
    ``stall_jitter`` (T, P, m), ``stall_u`` and ``stall_e`` (T, P).  Any
    object with these two methods can stand in (the tests feed the
    reference's own draws that way)."""

    def __init__(self, seed_lo: torch.Tensor, seed_hi: torch.Tensor, *, m: int, q: int,
                 sigma: bool, tail: bool, intf: bool, stall: bool):
        if not (1 <= m <= MAX_LANES and 1 <= q <= MAX_LANES):
            raise ValueError(f"m={m} and q={q} must lie in 1..{MAX_LANES}")
        self.k0 = seed_lo.to(torch.int64) & _MASK
        self.k1 = seed_hi.to(torch.int64) & _MASK
        self.m, self.q = m, q
        self.sigma, self.tail, self.intf, self.stall = sigma, tail, intf, stall

    def _block(self, slots: torch.Tensor, stream: int, block: int):
        # slots (T, 1) x keys (1, P) -> four (T, P) words
        return philox4x32_10(slots, stream, block, 0, self.k0[None, :], self.k1[None, :])

    def initial(self) -> torch.Tensor:
        zero = torch.zeros((1, 1), dtype=torch.int64, device=self.k0.device)
        return lanes(self._block(zero, INIT, 0), "u", self.m)[0]

    def chunk(self, t0: int, t1: int) -> dict[str, torch.Tensor]:
        slots = torch.arange(t0, t1, dtype=torch.int64, device=self.k0.device)[:, None]
        out = {"z_q": lanes(self._block(slots, NORMAL, 0), "z", self.q)}
        if self.sigma:
            out["z_m"] = lanes(self._block(slots, NORMAL, 1), "z", self.m)
        for flag, stream, name in ((self.tail, TAIL, "tail"), (self.intf, INTF, "intf")):
            if flag:
                out[f"{name}_u"] = lanes(self._block(slots, stream, 0), "u", self.m)
                out[f"{name}_e"] = lanes(self._block(slots, stream, 1), "e", self.m)
        if self.stall:
            start = self._block(slots, STALL, 0)
            out["stall_u"] = uniform(start[0])
            out["stall_e"] = exponential(uniform(start[1]))
            out["stall_jitter"] = lanes(self._block(slots, STALL, 1), "u", self.m)
        return out
