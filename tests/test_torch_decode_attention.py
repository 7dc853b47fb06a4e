"""The port's decode attention against the JAX package's: the same numpy
inputs through JAX ``decode_attention`` (the Pallas kernel in interpret
mode) and the port's wrapper, which on CPU tensors computes its plain
version.  Sweep and tolerances are those of tests/test_kernels.py (f32
2e-5, bf16 2e-2).  The bf16 kernel's arithmetic (the "mma" route: bf16
operands on the tensor cores, P rounded to bf16 before P V, warps that
split each tile's keys, pieces merged by the combine) is emulated here and
held against the same JAX kernel.  So is the f32 route's (one launch: the
visible rows spread evenly over the blocks from ``pos``, 32-key slices,
partial dots over 32-column chunks, a softmax per slice, a partial a shared
unit, merged in block order), and its schedule is checked row by row and
pinned to the source.  The kernels themselves run only on a card: their
tests are marked ``gpu`` and skip here."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention import (
    reference_decode_attention as jax_reference_decode_attention,
)
from repro_torch.kernels import decode_attention, reference_decode_attention
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.kernel import piece_len

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, b, h, kv, hd, t, dtype, pos=None, q_scale=1.0):
    """q, k, v (f32 numpy normals, q times ``q_scale``, cast by each
    package) and pos, for both."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, h, hd), (b, t, kv, hd), (b, t, kv, hd))]
    xs[0] *= np.float32(q_scale)
    p = rng.integers(0, t, b) if pos is None else np.asarray(pos)
    p = p.astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jdt) for x in xs] + [jnp.asarray(p)],
            [torch.from_numpy(x).to(tdt) for x in xs] + [torch.from_numpy(p)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,hd,t,bk", [
    (2, 4, 4, 64, 256, 64),
    (3, 8, 2, 64, 512, 128),
    (1, 4, 1, 128, 256, 256),
])
def test_decode_attention_matches_jax_kernel(dtype, b, h, kv, hd, t, bk):
    jx, tx = _inputs(hash((b, h, kv, hd, t)) % 2**31, b, h, kv, hd, t, dtype)
    ref = jax_decode_attention(*jx, block_k=bk)
    out = decode_attention(*tx)
    assert out.dtype == tx[0].dtype and out.shape == tx[0].shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


def test_decode_attention_ragged_positions_match_jax():
    """Each sequence has its own length; pos=0 attends to kv row 0 only."""
    b, h, kv, hd, t = 4, 4, 2, 64, 128
    jx, tx = _inputs(11, b, h, kv, hd, t, "float32", pos=[0, 1, 63, 127])
    ref = jax_decode_attention(*jx, block_k=32)
    out = decode_attention(*tx)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])
    got = _np(out[0]).reshape(kv, h // kv, hd)
    for g in range(kv):
        np.testing.assert_allclose(got[g], np.broadcast_to(_np(tx[2][0, 0, g]), got[g].shape),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [16, 64])
def test_decode_attention_local_window_matches_jax(window):
    jx, tx = _inputs(13, 2, 4, 4, 64, 128, "float32", pos=[100, 127])
    ref = jax_decode_attention(*jx, window=window, block_k=32)
    out = decode_attention(*tx, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_decode_attention_softcap_matches_jax():
    """q is scaled so that the logits (std 32) reach past the softcap."""
    jx, tx = _inputs(17, 2, 8, 4, 128, 256, "float32", q_scale=32.0)
    ref = jax_decode_attention(*jx, softcap=50.0, block_k=64)
    out = decode_attention(*tx, softcap=50.0)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])
    uncapped = decode_attention(*tx)
    assert np.abs(_np(uncapped) - _np(out)).max() > 0.1


def test_decode_attention_gemma_2b_heads_match_jax():
    """gemma-2b's heads (H=8, one KV head, hd=256) in bf16."""
    jx, tx = _inputs(19, 2, 8, 1, 256, 512, "bfloat16", pos=[511, 200])
    ref = jax_decode_attention(*jx, block_k=128)
    out = decode_attention(*tx)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 30.0)])
def test_reference_decode_attention_matches_jax_reference(window, softcap):
    jx, tx = _inputs(23, 3, 8, 2, 64, 128, "float32")
    ref = jax_reference_decode_attention(*jx, window=window, softcap=softcap)
    out = reference_decode_attention(*tx, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_decode_attention_on_cpu_is_the_plain_version_and_counts_nothing():
    _, (q, k, v, pos) = _inputs(29, 2, 4, 2, 64, 64, "float32")
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos.long(), window=8, softcap=10.0)
    ref = reference_decode_attention(q, k, v, pos, window=8, softcap=10.0)
    assert torch.equal(out, ref)
    assert decode_attention.launches == before == 0


@pytest.mark.parametrize("b,h,kv,t,piece", [
    (4, 8, 1, 2048, 64),      # gemma-2b decode: 128 blocks even at 64 positions
    (4, 8, 4, 8192, 512),     # gemma2-2b local layer
    (4, 8, 2, 8192, 256),     # kernels_bench's shape
    (1, 32, 1, 64, 64),       # four groups of 8 query heads, one piece
])
def test_piece_len_is_the_longest_that_fills_the_sms(b, h, kv, t, piece):
    assert piece_len(b, h, kv, t, 132) == piece


NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634
TILE, WARPS = 64, 4          # rows per shared-memory tile; warps that split them


def _mma_emulation(q, k, v, pos, *, window, softcap, piece):
    """The bf16 "mma" route's arithmetic on the CPU, as its two kernels walk
    it.  Split: a piece of ``piece`` positions keeps its visible rows
    [lo, hi) and walks them in 64-row tiles from lo; each of 4 warps takes
    16 rows of every tile and keeps its own online softmax in log2 units
    (f32 logits from the bf16 operands, scale, softcap, rows past hi
    masked, P rounded to bf16 before P V, f32 accumulators).  One merge over
    the warps gives the piece's (m, l, acc), m back in natural units; a
    piece with nothing visible is neutral.  Combine: the pieces that are not
    neutral, merged, divided by l (1 where l == 0, so a row that sees no key
    gives 0)."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    out = torch.zeros(b, h, hd)
    for bi in range(b):
        p = int(pos[bi])
        qf = q[bi].float()
        parts = []
        for base in range(0, t, piece):
            lo = max(p - window + 1 if window else 0, base)
            hi = min(p + 1, t, base + piece)
            if lo >= hi:
                continue
            warps = []
            for w in range(WARPS):
                m, l, acc = torch.full((h,), NEG_INF), torch.zeros(h), torch.zeros(h, hd)
                for t0 in range(lo, hi, TILE):
                    rows = torch.arange(t0 + 16 * w, t0 + 16 * w + 16)
                    ok = rows < hi             # rows past hi arrive as zeros
                    rows = rows.clamp(max=t - 1)
                    x = torch.einsum("hd,rhd->hr", qf, kf[bi, rows]) * scale
                    if softcap:
                        x = softcap * torch.tanh(x / softcap)
                    x = torch.where(ok, x * LOG2E, NEG_INF)
                    m_new = torch.maximum(m, x.amax(-1))
                    pr = torch.where(ok, torch.exp2(x - m_new[:, None]), 0.0)
                    corr = torch.exp2(m - m_new)
                    l = l * corr + pr.sum(-1)
                    acc = acc * corr[:, None] + torch.einsum(
                        "hr,rhd->hd", pr.bfloat16().float(), vf[bi, rows] * ok[:, None, None])
                    m = m_new
                warps.append((m, l, acc))
            ms = torch.stack([w[0] for w in warps])
            c = torch.exp2(ms - ms.amax(0))
            parts.append((ms.amax(0) / LOG2E, (c * torch.stack([w[1] for w in warps])).sum(0),
                          (c[..., None] * torch.stack([w[2] for w in warps])).sum(0)))
        if parts:
            ms = torch.stack([pt[0] for pt in parts])
            c = torch.exp(ms - ms.amax(0))
            big_l = (c * torch.stack([pt[1] for pt in parts])).sum(0)
            acc = (c[..., None] * torch.stack([pt[2] for pt in parts])).sum(0)
            out[bi] = acc / torch.where(big_l == 0, 1.0, big_l)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,h,kv,hd,t,bk,pos,window,softcap,q_scale", [
    (2, 4, 4, 64, 256, 64, None, 0, 0.0, 1.0),       # the bf16 sweep of the reference's tests
    (3, 8, 2, 64, 512, 128, None, 0, 0.0, 1.0),
    (1, 4, 1, 128, 256, 256, None, 0, 0.0, 1.0),
    (4, 4, 2, 64, 128, 32, (0, 1, 63, 127), 0, 0.0, 1.0),   # ragged pos, pos = 0
    (2, 4, 4, 64, 128, 32, (100, 127), 16, 0.0, 1.0),       # windows
    (2, 4, 4, 64, 128, 32, (100, 127), 64, 0.0, 1.0),
    (2, 8, 4, 128, 256, 64, None, 0, 50.0, 32.0),    # logits (std 32) past the softcap
    (2, 16, 1, 64, 192, 64, (191, 70), 0, 0.0, 1.0),  # 16 heads a group: two head chunks
    (2, 8, 2, 128, 200, 40, (199, 130), 0, 0.0, 1.0),  # T not a multiple of 64
    (2, 8, 1, 256, 512, 128, (511, 200), 0, 0.0, 1.0),  # gemma-2b heads
])
def test_mma_arithmetic_matches_jax_kernel(b, h, kv, hd, t, bk, pos, window, softcap, q_scale):
    """Rounding P to bf16 is the one step the reference's kernel does not
    take; with it the bf16 route stays inside the reference's 2e-2 at every
    piece length the wrapper can pick (1 to 8 tiles a piece)."""
    jx, tx = _inputs(hash((b, h, kv, hd, t, window)) % 2**31, b, h, kv, hd, t, "bfloat16",
                     pos=pos, q_scale=q_scale)
    ref = jax_decode_attention(*jx, window=window, softcap=softcap, block_k=bk)
    for piece in da_kernel.PIECES:
        out = _mma_emulation(*tx, window=window, softcap=softcap, piece=piece)
        assert out.dtype == torch.bfloat16 and out.shape == tx[0].shape
        np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])
    if pos is not None and pos[0] == 0:       # pos = 0 sees kv row 0 only
        got = _np(out[0]).reshape(kv, h // kv, hd)
        for g in range(kv):
            np.testing.assert_allclose(got[g], np.broadcast_to(_np(tx[2][0, 0, g]), got[g].shape))


@pytest.fixture
def one_thread():
    """The emulations' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CSRC = Path(da_kernel.__file__).parents[1] / "csrc"
SLICE = da_kernel.SLICE


def _unit(u, h, kv):
    """Unit u -> (batch row, first query head, heads)."""
    group = h // kv
    n_hc = -(-group // 8)
    bi, rem = divmod(u, kv * n_hc)
    kvh, hc = divmod(rem, n_hc)
    return bi, kvh, kvh * group + 8 * hc, min(8, group - 8 * hc)


def _f32_emulation(q, k, v, pos, *, window, softcap, grid):
    """The f32 route's arithmetic on the CPU, as its one launch walks it.
    The schedule (``kernel.f32_schedule``) gives each block its segments;
    a segment is walked in slices of 32 rows from its first row (rows past
    its end arrive as zeros and are masked).  Per slice: q kᵀ as partial
    dots over 32-column chunks of hd, summed in chunk order; scale, softcap,
    mask; the slice's max per head, the online softmax with one running sum
    a key position (summed at the segment's end); O = O corr + P V.  A
    segment that is its whole unit writes the output; the others leave (m,
    l, acc) in their block's slot, merged in block order in two levels
    (groups of ceil(sqrt(n)) blocks, then the groups): weights exp(m - M),
    A / L (1 where L == 0).  A unit with no visible row gives 0."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    sched = da_kernel.f32_schedule(pos.tolist(), b=b, h=h, kv=kv, t=t, window=window,
                                   grid=grid)
    out = torch.zeros(b, h, hd)
    parts = {}
    for blk, segs in enumerate(sched["blocks"]):
        for seg in segs:
            bi, kvh, h0, gc = _unit(seg["unit"], h, kv)
            qf = q[bi, h0:h0 + gc].float()
            m, l = torch.full((gc,), NEG_INF), torch.zeros(gc, SLICE)
            acc = torch.zeros(gc, hd)
            for r0 in range(seg["lo"], seg["hi"], SLICE):
                rows = torch.arange(r0, r0 + SLICE)
                ok = rows < seg["hi"]
                rows = rows.clamp(max=t - 1)
                kk = k[bi, rows, kvh].float() * ok[:, None]
                vv = v[bi, rows, kvh].float() * ok[:, None]
                x = torch.zeros(gc, SLICE)
                for c0 in range(0, hd, 32):
                    x = x + qf[:, c0:c0 + 32] @ kk[:, c0:c0 + 32].T
                x = x * scale
                if softcap:
                    x = softcap * torch.tanh(x / softcap)
                x = torch.where(ok, x, NEG_INF)
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(x - m_new[:, None]), 0.0)
                l = l * corr[:, None] + p
                acc = acc * corr[:, None] + p @ vv
                m = m_new
            big_l = l.sum(-1)
            if seg["slot"] is None:
                out[bi, h0:h0 + gc] = acc / torch.where(big_l == 0, 1.0, big_l)[:, None]
            else:
                parts[blk, seg["slot"]] = (m, big_l, acc)
    def merge(partials):
        ms = torch.stack([pt[0] for pt in partials])
        big_m = ms.amax(0)
        w = torch.exp(ms - big_m)
        big_l = (w * torch.stack([pt[1] for pt in partials])).sum(0)
        return big_m, big_l, (w[..., None] * torch.stack([pt[2] for pt in partials])).sum(0)

    for u, tree in enumerate(sched["merge_groups"]):
        if tree is None:
            continue
        bi, _, h0, gc = _unit(u, h, kv)
        groups = [merge([parts[s] for s in g]) for g in tree["groups"]]
        _, big_l, a = groups[0] if len(groups) == 1 else merge(groups)
        out[bi, h0:h0 + gc] = a / torch.where(big_l == 0, 1.0, big_l)[:, None]
    return out.to(q.dtype)


# blocks an SM holds on an H100 (228 KB of shared memory an SM, 1 KB of it
# reserved a block) by hd, from the source's shared-memory layout
# (``_f32_smem_bytes``); the card's own count comes from the kernel
# (``decode_f32_blocks_per_sm``, chip_smoke phase 1)
H100_BLOCKS_PER_SM = {64: 4, 128: 2, 256: 1}


def _f32_grids(b, h, kv, hd, t, window):
    """One block, five, and the H100's one wave."""
    full = da_kernel.f32_grid(b, h, kv, t, window, 132, H100_BLOCKS_PER_SM[hd])
    return sorted({1, 5, full})


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("b,h,kv,hd,t,bk,pos,window,softcap,q_scale", [
    (2, 4, 4, 64, 256, 64, None, 0, 0.0, 1.0),       # the f32 sweep of the reference's tests
    (3, 8, 2, 64, 512, 128, None, 0, 0.0, 1.0),
    (1, 4, 1, 128, 256, 256, None, 0, 0.0, 1.0),
    (4, 4, 2, 64, 128, 32, (0, 1, 63, 127), 0, 0.0, 1.0),   # ragged pos, pos = 0
    (2, 4, 4, 64, 128, 32, (100, 127), 16, 0.0, 1.0),       # windows
    (2, 4, 4, 64, 128, 32, (100, 127), 64, 0.0, 1.0),
    (2, 8, 4, 128, 256, 64, None, 0, 50.0, 32.0),    # logits (std 32) past the softcap
    (2, 16, 1, 64, 192, 64, (191, 70), 0, 0.0, 1.0),  # 16 heads a group: two units a kv head
    (2, 8, 1, 256, 512, 128, (511, 200), 0, 0.0, 1.0),  # gemma-2b heads
])
def test_f32_arithmetic_matches_jax_kernel(b, h, kv, hd, t, bk, pos, window, softcap, q_scale):
    """The f32 route's arithmetic within the reference's 2e-5 of the Pallas
    kernel, with one block (every unit whole in it), five (units split over
    blocks, blocks across units) and the H100's grid."""
    jx, tx = _inputs(hash((b, h, kv, hd, t, window, "f32")) % 2**31, b, h, kv, hd, t,
                     "float32", pos=pos, q_scale=q_scale)
    ref = jax_decode_attention(*jx, window=window, softcap=softcap, block_k=bk)
    for grid in _f32_grids(b, h, kv, hd, t, window):
        out = _f32_emulation(*tx, window=window, softcap=softcap, grid=grid)
        assert out.dtype == torch.float32 and out.shape == tx[0].shape
        np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"], err_msg=f"grid {grid}")
    if pos is not None and pos[0] == 0:       # pos = 0 sees kv row 0 only
        got = _np(out[0]).reshape(kv, h // kv, hd)
        for g in range(kv):
            np.testing.assert_allclose(got[g], np.broadcast_to(_np(tx[2][0, 0, g]), got[g].shape),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.usefixtures("one_thread")
def test_f32_row_with_no_visible_key_gives_zero():
    """pos = -1 leaves a batch row no visible key: its unit reads nothing and
    its output is 0 (the TPU kernel's l == 0 -> 1); the other rows are
    unchanged by it."""
    _, tx = _inputs(41, 3, 8, 2, 64, 96, "float32", pos=(95, -1, 40))
    ref = reference_decode_attention(*tx)
    for grid in (1, 4, 9):
        sched = da_kernel.f32_schedule([95, -1, 40], b=3, h=8, kv=2, t=96, window=0, grid=grid)
        assert all(seg["unit"] not in (2, 3) for segs in sched["blocks"] for seg in segs)
        out = _f32_emulation(*tx, window=0, softcap=0.0, grid=grid)
        assert torch.equal(out[1], torch.zeros_like(out[1]))
        np.testing.assert_allclose(_np(out[[0, 2]]), _np(ref[[0, 2]]), **TOL["float32"])


def _check_schedule(pos, b, h, kv, t, window, grid):
    """Every visible row read by exactly one block, no row outside its
    unit's visible range, the blocks' tiles within one of each other, two
    partial slots a block at most (the scratch the wrapper allocates), and
    each merge reading exactly the slots its unit's blocks wrote.  With
    fewer rows than blocks, the blocks past the rows take none."""
    sched = da_kernel.f32_schedule(pos, b=b, h=h, kv=kv, t=t, window=window, grid=grid)
    units = da_kernel.f32_units(b, h, kv)
    assert len(sched["visible"]) == units and len(sched["blocks"]) == grid
    read = [[] for _ in range(units)]
    written, group_slots = {}, []
    rows = []
    for blk, segs in enumerate(sched["blocks"]):
        slots = [seg["slot"] for seg in segs if seg["slot"] is not None]
        assert len(slots) == len(set(slots)) <= 2 and set(slots) <= {0, 1}
        assert all(seg["slot"] is None for seg in segs[1:-1])   # middle units: whole here
        n = 0
        for seg in segs:
            u, lo, hi = seg["unit"], seg["lo"], seg["hi"]
            vlo, vhi = sched["visible"][u]
            assert vlo <= lo < hi <= vhi and (lo - vlo) % SLICE == 0   # whole tiles
            for r0 in range(lo, hi, SLICE):                     # the slices' rows
                read[u].extend(range(r0, min(r0 + SLICE, hi)))
            n += -(-(hi - lo) // SLICE)
            if seg["slot"] is not None:
                written.setdefault(u, []).append((blk, seg["slot"]))
        rows.append(n)
    for u, (vlo, vhi) in enumerate(sched["visible"]):
        assert sorted(read[u]) == list(range(vlo, vhi)), u
        want = written.get(u, [])
        if len(sched["contributors"][u]) > 1:
            assert sched["merge_slots"][u] == want, u
            tree = sched["merge_groups"][u]
            f = tree["fan_in"]
            assert f == len(want) <= 16 or (f - 1) ** 2 < len(want) <= f * f <= 32 * 32
            assert [s for g in tree["groups"] for s in g] == want
            assert all(len(g) == f for g in tree["groups"][:-1]) and len(tree["groups"]) <= 32
            group_slots.extend(tree["group_slots"])
        else:
            assert not want and sched["merge_groups"][u] is None, u
    takers = [n for n in rows if n]
    assert max(rows) - min(takers, default=0) <= 1
    assert rows[:len(takers)] == takers     # the blocks that take rows come first
    slots = [2 * blk + s for blk, segs in enumerate(sched["blocks"]) for seg in segs
             if (s := seg["slot"]) is not None]
    assert len(group_slots) == len(set(group_slots)) and set(group_slots) <= set(slots)
    floats = da_kernel.f32_scratch_floats(b, h, kv, 64, grid)
    counters = da_kernel.f32_counters(b, h, kv, grid)
    assert counters >= units + 2 * grid     # a unit's count, then a group's by its slot
    assert (max(slots, default=0) + 1 + 2 * grid) * 8 * (64 + 2) <= floats - counters
    return sched, rows


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @settings(max_examples=200, deadline=None)
    @given(b=st.integers(1, 6), kv=st.integers(1, 4),
           group=st.sampled_from([1, 2, 3, 4, 5, 8, 12, 16]), t=st.integers(1, 3000),
           window=st.one_of(st.just(0), st.integers(1, 3100)), sms=st.integers(1, 140),
           per_sm=st.integers(1, 4), data=st.data())
    def test_f32_schedule_by_hypothesis(b, kv, group, t, window, sms, per_sm, data):
        pos = data.draw(st.lists(st.integers(-2, t + 3), min_size=b, max_size=b))
        grid = da_kernel.f32_grid(b, group * kv, kv, t, window, sms, per_sm)
        assert 1 <= grid <= min(sms * per_sm, da_kernel.MAX_BLOCKS)
        _check_schedule(pos, b, group * kv, kv, t, window, grid)


@pytest.mark.parametrize("name,b,h,kv,hd,t,window,pos", [
    ("kernels_bench", 4, 8, 2, 64, 8192, 0, (8191, 4096, 7, 8092)),
    ("gemma-2b decode f32", 4, 8, 1, 256, 2048, 0, (2047, 1024, 7, 1948)),
    ("gemma2-2b local f32", 4, 8, 4, 256, 8192, 4096, (8191, 4096, 7, 8092)),
])
def test_f32_schedule_at_the_timed_shapes(name, b, h, kv, hd, t, window, pos):
    """On an H100's grid every block holds visible rows (none is launched for
    nothing) and the tiles spread within one of each other."""
    grid = da_kernel.f32_grid(b, h, kv, t, window, 132, H100_BLOCKS_PER_SM[hd])
    assert grid == 132 * H100_BLOCKS_PER_SM[hd]
    _, rows = _check_schedule(list(pos), b, h, kv, t, window, grid)
    assert min(rows) > 0


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _f32_smem_bytes(hd, gc):
    """``F32Smem<hd, gc>::BYTES``: the ring (3 stages of a K and a V slice),
    two q buffers, the warps' partial dots, P, the rescales and (m, l) of 8
    heads, 32 words for the schedule."""
    nw, stages = hd // 32, da_kernel.STAGES
    floats = (stages * 2 * SLICE * hd + (stages - 1) * gc * hd + nw * gc * SLICE + SLICE * gc
              + 8 + 16 + 32)
    return 4 * floats


def test_f32_schedule_and_layout_match_the_source():
    """The mirror's constants and rules are the source's: slice, ring depth,
    grid cap, units of 8 heads, the rows a block takes, the block of a row,
    the grid of one wave, the scratch (counters, then two slots a block of
    8 heads' (m, l) and acc), the slot a block writes and the slot a merge
    reads; and the shared memory that sets the H100's blocks an SM."""
    src = (CSRC / "decode_attention.cu").read_text()
    flat = " ".join(src.split())
    assert _const(src, "kSlice") == da_kernel.SLICE == 32
    assert _const(src, "kStages") == da_kernel.STAGES == 3
    assert _const(src, "kMaxBlocks") == da_kernel.MAX_BLOCKS
    assert _const(src, "GMAX") == da_kernel._GROUP_MAX == 8
    for line in (
            "const int G = (int)min((long long)gridDim.x, max(R, 1LL));",
            "const long long s_beg = takes_tiles ? (long long)blockIdx.x * R / G : 0;",
            "const long long s_end = takes_tiles ? (long long)(blockIdx.x + 1) * R / G : 0;",
            "__device__ __forceinline__ int tiles_of(int rows) { return (rows + kSlice - 1) / kSlice; }",
            "const int nt = tiles_of(len);",
            "w.lo = lo + kSlice * a; w.hi = lo + (int)min((long long)len, kSlice * (s_end - w.g0));",
            "if (n <= kFlat) fan_in = n;",
            "return (int)(((r + 1) * G - 1) / R);",
            "lo = window > 0 ? max(p - window + 1, 0) : 0; len = max(hi - lo, 0);",
            "const int hi = min(p + 1, T);",
            "const Units un{pos, B * KV * n_hc, KV * n_hc, n_hc, group, T, window};",
            "int* unit_count = scratch;",
            "int* group_count = scratch + un.U;",
            "float* slots = reinterpret_cast<float*>(scratch) + ((un.U + 2 * gridDim.x + 3) & ~3);",
            "float* group_slots = slots + 2L * gridDim.x * L::SLOT;",
            "static constexpr int SLOT = GMAX * (HD + 2);",
            "float* slot = slots + ((long)blockIdx.x * 2 + (cw.ord == 0 ? 0 : 1)) * L::SLOT;",
            "fan_in = 1; while (fan_in * fan_in < n) ++fan_in;",
            "groups = (n + fan_in - 1) / fan_in;",
            "first_which = (long long)bf * R / G < g0 ? 1 : 0;",
            "__device__ int member_slot(int j) const { return 2 * (bf + j) + (j == 0 ? first_which "
            ": 0); }",
            "__device__ int slot(int gi) const { return member_slot(gi * fan_in); }",
            "const long long rows_max = units * (window > 0 ? std::min(T_len, window) : T_len);",
            "long long grid = (long long)sms * per_sm; grid = std::min(grid, (long long)kMaxBlocks); "
            "grid = std::max(1LL, std::min(grid, (rows_max + kSlice - 1) / kSlice));",
            "inline int f32_heads(int group) { return group >= 5 ? 8 : group >= 3 ? 4 : group; }",
            "static constexpr int QBUF = kStages * STAGE;",
            "static constexpr int PART = QBUF + (kStages - 1) * GC * HD;",
            "static constexpr int PROB = PART + NW * GC * kSlice;",
            "static constexpr int CORR = PROB + kSlice * GC;",
            "static constexpr int ML = CORR + GMAX;",
            "static constexpr int MISC = ML + 2 * GMAX;",
            "static constexpr size_t BYTES = sizeof(float) * (MISC + 32);"):
        assert line in flat, line
    assert _const(src, "kFlat") == da_kernel.FLAT
    for n in range(1, da_kernel.MAX_BLOCKS + 1):            # MergeTree's fan-in loop
        f = 1
        while f * f < n:
            f += 1
        f = n if n <= da_kernel.FLAT else f
        assert da_kernel.merge_fan_in(n) == f <= 32 and -(-n // f) <= 32
    for hd, per_sm in H100_BLOCKS_PER_SM.items():
        for gc in (1, 2, 4, 8):
            smem = _f32_smem_bytes(hd, gc)
            assert smem <= 232_448
            assert min(228 * 1024 // (smem + 1024), 2048 // hd) >= per_sm, (hd, gc)
        assert 228 * 1024 // (_f32_smem_bytes(hd, 8) + 1024) == per_sm


@pytest.mark.parametrize("b,h,kv,t,window,units,grid", [
    (4, 8, 2, 8192, 0, 8, 528),        # kernels_bench: 4 blocks an SM, 132 SMs
    (4, 8, 1, 2048, 0, 4, 132),        # gemma-2b f32: one block an SM
    (4, 8, 4, 8192, 4096, 16, 132),    # gemma2-2b local f32
    (1, 32, 1, 64, 0, 4, 8),           # 4 units of 8 heads, 64 rows each at most
    (1, 2, 1, 5, 0, 1, 1),             # fewer rows than a slice: one block
])
def test_f32_grid_is_one_wave_capped_by_the_rows(b, h, kv, t, window, units, grid):
    assert da_kernel.f32_units(b, h, kv) == units
    per_sm = 4 if grid == 528 else 1
    assert da_kernel.f32_grid(b, h, kv, t, window, 132, per_sm) == grid


def test_routes_by_dtype_and_cpu_calls_count_nothing():
    """bf16 goes to the mma kernel (dtype code 1), f32 to the CUDA-core
    kernel (code 0); a CPU call computes the plain version and leaves every
    counter at 0."""
    assert da_ops.ROUTES == {torch.bfloat16: "mma", torch.float32: "simt"}
    assert {da_ops.ROUTES[d]: da_kernel._DTYPE_CODE[d] for d in da_ops.ROUTES} == {
        "mma": 1, "simt": 0}
    for dtype in ("bfloat16", "float32"):
        _, (q, k, v, pos) = _inputs(37, 2, 8, 2, 64, 96, dtype)
        out = decode_attention(q, k, v, pos, window=16, softcap=10.0)
        assert torch.equal(out, reference_decode_attention(q, k, v, pos, window=16,
                                                           softcap=10.0))
    assert decode_attention.launches == 0
    assert decode_attention.launches_by_route == {"mma": 0, "simt": 0}


@pytest.mark.parametrize("case,error", [
    ("shape", ValueError), ("head_dim", ValueError), ("dtype", TypeError),
    ("heads", ValueError), ("pos", TypeError), ("window", ValueError)])
def test_decode_attention_rejects_bad_inputs(case, error):
    _, (q, k, v, pos) = _inputs(31, 2, 4, 2, 64, 32, "float32")
    kwargs = {}
    if case == "shape":
        q = q[:, None]
    elif case == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif case == "dtype":
        k = k.double()
    elif case == "heads":
        q = q[:, :3]
    elif case == "pos":
        pos = pos.float()
    else:
        kwargs["window"] = -1
    with pytest.raises(error):
        decode_attention(q, k, v, pos, **kwargs)


def test_cpu_path_stays_differentiable():
    _, (q, k, v, pos) = _inputs(3, 2, 4, 2, 64, 32, "float32")
    q.requires_grad_(True)
    decode_attention(q, k, v, pos).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape and torch.isfinite(q.grad).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype):
    """Both routes (bf16 -> mma, f32 -> simt), each launch counted on its
    route, at gemma-2b heads and a group of 16 with window and softcap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    route = da_ops.ROUTES[tdt]
    gen = torch.Generator(cuda_device).manual_seed(0)
    for b, h, kv, hd, t, window, cap in ((2, 4, 4, 64, 256, 0, 0.0),
                                         (4, 8, 1, 256, 2048, 0, 0.0),
                                         (3, 16, 1, 128, 1000, 64, 50.0)):
        q_scale = 32.0 if cap else 1.0     # logits that reach past the softcap
        q = (q_scale * torch.randn(b, h, hd, generator=gen, device=cuda_device)).to(tdt)
        k, v = (torch.randn(b, t, kv, hd, generator=gen, device=cuda_device).to(tdt)
                for _ in range(2))
        pos = torch.randint(0, t, (b,), generator=gen, device=cuda_device)
        before = decode_attention.launches
        before_route = decode_attention.launches_by_route[route]
        out = decode_attention(q, k, v, pos, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        assert decode_attention.launches_by_route[route] == before_route + 1
        ref = reference_decode_attention(q, k, v, pos, window=window, softcap=cap)
        # bf16: 5e-3 of max|ref| and one ulp of rounding, well below the
        # reference's 2e-2 for outputs that average thousands of rows
        tol = TOL[dtype] if dtype == "float32" else dict(
            atol=5e-3 * float(ref.float().abs().max()), rtol=1e-2)
        np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_refuses_grad_on_card(cuda_device, dtype):
    """No backward kernel: under grad mode an input that requires grad
    raises instead of giving an output that autograd cannot see into."""
    tdt = DTYPES[dtype][1]
    gen = torch.Generator(cuda_device).manual_seed(1)
    q = torch.randn(2, 8, 64, generator=gen, device=cuda_device).to(tdt)
    k, v = (torch.randn(2, 128, 2, 64, generator=gen, device=cuda_device).to(tdt)
            for _ in range(2))
    pos = torch.tensor([127, 40], device=cuda_device)
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, v, pos)
    with torch.no_grad():
        out = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()


F32_SHAPES = (   # chip_smoke's f32 rows: (B, H, KV, hd, T, window, softcap, pos, q scale)
    (4, 8, 2, 64, 8192, 0, 0.0, (8191, 4096, 7, 8092), 1.0),
    (4, 8, 1, 256, 2048, 0, 0.0, (2047, 1024, 7, 1948), 1.0),
    (4, 8, 4, 256, 8192, 4096, 50.0, (8191, 4096, 7, 8092), 32.0),
)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,hd,t,window,cap,pos,q_scale", F32_SHAPES)
def test_f32_route_at_full_width_on_card(cuda_device, b, h, kv, hd, t, window, cap, pos,
                                         q_scale):
    """The one-launch f32 route within 2e-5 of the plain version at the
    timed shapes, each launch counted once on "simt", and two calls bit for
    bit alike (the merge takes the partials in block order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(cuda_device).manual_seed(3)
    q = q_scale * torch.randn(b, h, hd, generator=gen, device=cuda_device)
    k, v = (torch.randn(b, t, kv, hd, generator=gen, device=cuda_device) for _ in range(2))
    p = torch.tensor(pos, device=cuda_device)
    before, before_route = decode_attention.launches, decode_attention.launches_by_route["simt"]
    out = decode_attention(q, k, v, p, window=window, softcap=cap)
    again = decode_attention(q, k, v, p, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert decode_attention.launches_by_route["simt"] == before_route + 2
    assert torch.equal(out, again)
    ref = reference_decode_attention(q, k, v, p, window=window, softcap=cap)
    np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **TOL["float32"])


@pytest.mark.gpu
def test_f32_row_with_no_visible_key_gives_zero_on_card(cuda_device):
    """pos = -1: that batch row's output is 0; the others match the plain
    version."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    q = torch.randn(3, 8, 128, generator=gen, device=cuda_device)
    k, v = (torch.randn(3, 300, 2, 128, generator=gen, device=cuda_device) for _ in range(2))
    p = torch.tensor([299, -1, 40], device=cuda_device)
    out = decode_attention(q, k, v, p, window=64)
    torch.cuda.synchronize()
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    ref = reference_decode_attention(q, k, v, p, window=64)
    np.testing.assert_allclose(_np(out[[0, 2]].cpu()), _np(ref[[0, 2]].cpu()), **TOL["float32"])
