"""ctypes binding of ``csrc/decode_attention.cu`` (counterpart of the
reference's ``kernel.py``, which holds the Pallas ``pallas_call``).

The bf16 route is a split over pieces of T (``piece_len``) and a combine.
The f32 route is one launch (``decode_split_f32``) whose schedule this
module mirrors: ``f32_grid`` sizes its grid, ``f32_schedule`` gives each
block's segments and each unit's contributors, ``f32_scratch_floats`` the
scratch it needs.  The source holds the same rule (``kSlice``, ``kStages``,
``kMaxBlocks``, ``block_of``, ``MergeTree``); ``tests/test_torch_decode_attention.py``
pins the two together.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import load_library

__all__ = ["build", "launch_decode_attention", "piece_len", "PIECES", "SLICE", "STAGES",
           "MAX_BLOCKS", "f32_units", "f32_grid", "f32_counters", "f32_scratch_floats",
           "merge_fan_in", "f32_schedule"]

_SOURCE = "decode_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, pos, out, scratch, B, T, H, KV, hd, dtype, piece_len, window,
    # softcap, scale, device, stream
    "decode_attention_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _I, _P]),
    "decode_attention_error_string": (ctypes.c_char_p, [_I]),
}
# hd, H / KV, device -> blocks of the f32 route's kernel an SM holds (a
# negative cudaError_t on failure); bound where the library has it (an older
# source, timed against this one, has another f32 route)
_F32_BLOCKS = "decode_f32_blocks_per_sm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GROUP_MAX = 8   # query heads one block serves (GMAX in the source)
PIECES = (64, 128, 256, 512)   # positions per block that piece_len chooses from
SLICE = 32        # rows a ring stage holds, one key a lane (kSlice)
STAGES = 3        # ring depth (kStages)
MAX_BLOCKS = 1024  # the f32 grid's cap (kMaxBlocks): a merge takes at most 32 partials
FLAT = 16          # a unit of up to 16 blocks merges in one level (kFlat)


def build(source: str = _SOURCE):
    """Build (once) and load the kernel's library; ``source`` may name
    another file with the same C interface (an absolute path), for an A/B
    of two versions of the kernel in one process."""
    lib = load_library(source, _SIGNATURES)
    if hasattr(lib, _F32_BLOCKS):
        fn = getattr(lib, _F32_BLOCKS)
        fn.restype, fn.argtypes = _I, [_I, _I, _I]
    return lib


def piece_len(b: int, h: int, kv: int, t: int, sms: int) -> int:
    """bf16 route: positions per block for B=b, H=h, KV=kv and T=t on a
    card with ``sms`` SMs: the largest of ``PIECES`` that still gives one
    block per SM, else the smallest.  Longer pieces leave the combine fewer
    partials to walk; shorter ones fill more SMs."""
    blocks_per_piece = b * kv * -(-(h // kv) // _GROUP_MAX)
    for piece in reversed(PIECES):
        if blocks_per_piece * -(-t // piece) >= sms:
            return piece
    return PIECES[0]


def f32_units(b: int, h: int, kv: int) -> int:
    """Units of the f32 route: one per (batch row, kv head, chunk of up to 8
    query heads)."""
    return b * kv * -(-(h // kv) // _GROUP_MAX)


def f32_grid(b: int, h: int, kv: int, t: int, window: int, sms: int,
             blocks_per_sm: int) -> int:
    """Blocks of the f32 route's one launch: one wave (``blocks_per_sm`` a
    SM), at most ``MAX_BLOCKS``, and no more than a slice of rows each if
    every row of every unit were visible.  The host never reads ``pos``."""
    rows_max = f32_units(b, h, kv) * (min(t, window) if window > 0 else t)
    return max(1, min(sms * blocks_per_sm, MAX_BLOCKS, -(-rows_max // SLICE)))


def f32_counters(b: int, h: int, kv: int, grid: int) -> int:
    """int32 counters at the front of the f32 scratch, padded to 4: one a
    unit (its merged groups), two a block (a group's partials)."""
    return -(-(f32_units(b, h, kv) + 2 * grid) // 4) * 4


def f32_scratch_floats(b: int, h: int, kv: int, hd: int, grid: int) -> int:
    """f32 scratch (4-byte words): the counters, then two partial slots a
    block and as many group slots, each (m, l) and acc of 8 heads."""
    return f32_counters(b, h, kv, grid) + 4 * grid * _GROUP_MAX * (hd + 2)


def merge_fan_in(n: int) -> int:
    """Blocks a merge group takes when n blocks hold a unit: all of them up
    to ``FLAT``, else ceil(sqrt(n))."""
    return n if n <= FLAT else math.isqrt(n - 1) + 1


def f32_schedule(pos, *, b: int, h: int, kv: int, t: int, window: int, grid: int) -> dict:
    """The f32 route's schedule, as each block derives it from ``pos`` on
    the card.  Unit u = (batch row, kv head, head chunk) sees rows [lo, hi)
    of its sequence, in tiles of ``SLICE`` rows from lo; the units' tiles,
    in unit order, make one run of R tiles, and block i < G = min(grid, R)
    takes tiles [i R // G, (i + 1) R // G) of it (so each takes at least
    one, and two blocks' tiles differ by at most one; blocks past G none).
    A block walks each unit it touches (a segment) tile by tile.  Returns

    * ``visible``: per unit (lo, hi), hi >= lo;
    * ``blocks``: per block its segments, each a dict (unit, lo, hi: the
      unit's rows it reads, slot: the partial slot it writes, 0 for the
      block's first unit, 1 for its last, None where the block holds the
      whole unit and writes the output itself);
    * ``contributors``: per unit the blocks that hold a segment of it, in
      the order the merge takes them (unit with no visible row: []);
    * ``merge_slots``: per unit the (block, slot) pairs its merge reads;
    * ``merge_groups``: per unit held by n > 1 blocks, its merge tree:
      ``merge_slots`` in groups of ``merge_fan_in(n)``, each merged by its
      last block into the group slot of its first member (``group_slots``,
      2 block + slot), then the groups in order (one group: straight to the
      output).
    """
    group = h // kv
    n_hc = -(-group // _GROUP_MAX)
    per_b = kv * n_hc
    units = b * per_b
    visible = []
    for u in range(units):
        p = int(pos[u // per_b])
        hi = min(p + 1, t)
        lo = max(p - window + 1, 0) if window > 0 else 0
        visible.append((lo, max(hi, lo)))
    lens = [-(-(hi - lo) // SLICE) for lo, hi in visible]     # tiles a unit
    starts = [0] * units
    for u in range(1, units):
        starts[u] = starts[u - 1] + lens[u - 1]
    total = sum(lens)
    takers = min(grid, max(total, 1))

    def block_start(i: int) -> int:
        return min(i, takers) * total // takers

    def block_of(r: int) -> int:       # the block whose rows hold global row r
        return ((r + 1) * takers - 1) // total

    blocks = []
    for i in range(grid):
        s0, s1 = block_start(i), block_start(i + 1)
        segs = []
        for u in range(units):
            a, z = max(s0, starts[u]), min(s1, starts[u] + lens[u])
            if a >= z:
                continue
            whole = block_of(starts[u]) == block_of(starts[u] + lens[u] - 1)
            lo, hi = visible[u]
            segs.append({"unit": u, "lo": lo + SLICE * (a - starts[u]),
                         "hi": min(hi, lo + SLICE * (z - starts[u])),
                         "slot": None if whole else (0 if not segs else 1)})
        blocks.append(segs)
    contributors, merge_slots, merge_groups = [], [], []
    for u in range(units):
        if not lens[u]:
            contributors.append([])
            merge_slots.append([])
            merge_groups.append(None)
            continue
        bf, bl = block_of(starts[u]), block_of(starts[u] + lens[u] - 1)
        contributors.append(list(range(bf, bl + 1)))
        merge_slots.append([(i, 1 if i == bf and block_start(bf) < starts[u] else 0)
                            for i in range(bf, bl + 1)])
        n = bl - bf + 1
        if n == 1:
            merge_groups.append(None)
            continue
        f = merge_fan_in(n)
        groups = [merge_slots[u][i:i + f] for i in range(0, n, f)]
        merge_groups.append({"fan_in": f, "groups": groups,
                             "group_slots": [2 * g[0][0] + g[0][1] for g in groups]})
    return {"visible": visible, "blocks": blocks, "contributors": contributors,
            "merge_slots": merge_slots, "merge_groups": merge_groups}


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lib, hd: int, group: int, device: int) -> int:
    n = getattr(lib, _F32_BLOCKS)(hd, group, device)
    if n <= 0:
        msg = lib.decode_attention_error_string(-n).decode()
        raise RuntimeError(f"decode_attention f32 occupancy query failed: {msg} ({-n})")
    return n


# (library, device, stream) -> [scratch, leading int32 words known to be 0].
# The f32 route's counters must be 0 at launch, and each launch leaves them
# so; a call whose counters reach past the words a previous call left at 0
# zeroes them first.  One buffer a stream: calls on one stream run in turn,
# calls on two streams never share counters.
_F32_SCRATCH: dict[tuple, list] = {}


def _f32_scratch(lib, q, stream: int, floats: int, counters: int) -> torch.Tensor:
    key = (id(lib), q.device.index, stream)
    entry = _F32_SCRATCH.get(key)
    if entry is None or entry[0].numel() < floats:
        entry = _F32_SCRATCH[key] = [torch.zeros(floats, dtype=torch.float32,
                                                 device=q.device), floats]
    buf, clean = entry
    if counters > clean:
        buf[clean:counters].zero_()
    entry[1] = counters
    return buf


def launch_decode_attention(q, k, v, pos, out, *, window: int, softcap: float,
                            scale: float, piece: int | None = None, lib=None) -> None:
    """Launch the kernels on the current stream of ``q``'s device (``lib``,
    default this checkout's library).  bf16: split and combine, with
    ``piece`` positions per block (by default ``piece_len``'s choice).  f32:
    one launch over ``f32_grid`` blocks.  Shapes, types, devices and
    alignment are checked by the caller (``ops``); ``pos`` is int32."""
    lib = build() if lib is None else lib
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if piece is None:
        piece = piece_len(b, h, kv, t, _sm_count(device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
        grid = f32_grid(b, h, kv, t, window, _sm_count(device),
                        _blocks_per_sm(lib, hd, h // kv, device))
        scratch = _f32_scratch(lib, q, stream, f32_scratch_floats(b, h, kv, hd, grid),
                               f32_counters(b, h, kv, grid))
    else:
        scratch = torch.empty(b * h * -(-t // piece) * (hd + 2), dtype=torch.float32,
                              device=q.device)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, t, h, kv, hd, _DTYPE_CODE[q.dtype], piece, int(window),
        float(softcap), float(scale), device, stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} ({err})")
