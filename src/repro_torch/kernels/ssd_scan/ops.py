"""Public SSD chunk-scan wrapper and its plain PyTorch version.

``ssd_scan`` takes the model's layout, like the reference's
``ops.ssd_scan``: x (B,L,nh,hd), dt (B,L,nh), a (nh,), B and C (B,L,N).
For CUDA tensors it launches the hand-written kernels
(``csrc/ssd_scan.cu``) and counts the call in ``ssd_scan.launches`` and,
by the chunk outputs' block layout (heads a block, paired row tiles), in
``ssd_scan.launches_by_layout``; for
CPU tensors it folds heads into rows, as the reference wrapper does, and
computes ``reference_ssd_scan``.  It never falls back from the kernel to
the plain version.  The kernels have no backward: on CUDA tensors a call
under grad mode with an input that requires grad raises.
"""

from __future__ import annotations

import torch

from .._grad import refuse_grad
from .kernel import launch_ssd_scan

__all__ = ["fold_and_scan", "reference_ssd_scan", "ssd_scan"]

HEAD_DIMS = (16, 32, 64)
STATE_SIZES = (16, 32, 64, 128)
CHUNKS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def reference_ssd_scan(x, da, dt, bmat, cmat):
    """Plain version, the reference's ``ref.reference_ssd_scan`` in the
    kernel layout: x (BH,NC,Q,hd), da and dt (BH,NC,Q), bmat and cmat
    (BH,NC,Q,N) -> (y (BH,NC,Q,hd), h_final (BH,hd,N)), both f32 (f64 where
    x is f64, to measure how far an f32 computation is off).

    The sequential recurrence over all NC*Q positions, independent of the
    chunking: h = exp(da_t) h + dt_t x_t B_t^T, y_t = C_t . h."""
    bh, nc, q, hd = x.shape
    n = bmat.shape[-1]
    length = nc * q
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xs = x.reshape(bh, length, hd).to(ct)
    dts = dt.reshape(bh, length).to(ct)
    das = da.reshape(bh, length).to(ct)
    bs = bmat.reshape(bh, length, n).to(ct)
    cs = cmat.reshape(bh, length, n).to(ct)
    h = torch.zeros((bh, hd, n), dtype=ct, device=x.device)
    ys = torch.empty((bh, length, hd), dtype=ct, device=x.device)
    for t in range(length):
        h = torch.exp(das[:, t])[:, None, None] * h + \
            dts[:, t, None, None] * (xs[:, t, :, None] * bs[:, t, None, :])
        ys[:, t] = torch.einsum("bn,bdn->bd", cs[:, t], h)
    return ys.reshape(bh, nc, q, hd), h


def _check(x, dt, a, bmat, cmat, chunk: int) -> None:
    if x.dim() != 4 or bmat.dim() != 3:
        raise ValueError(f"want x (B,L,nh,hd) and bmat (B,L,N); got "
                         f"{tuple(x.shape)}, {tuple(bmat.shape)}")
    b, length, nh, hd = x.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, length, nh) or a.shape != (nh,)
            or bmat.shape != (b, length, n) or cmat.shape != bmat.shape):
        raise ValueError(f"incompatible shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, bmat {tuple(bmat.shape)}, "
                         f"cmat {tuple(cmat.shape)}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} not in {CHUNKS}")
    if length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of chunk {chunk}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} not in {STATE_SIZES}")
    if (x.dtype not in _DTYPES or bmat.dtype not in _DTYPES or cmat.dtype != bmat.dtype
            or dt.dtype != torch.float32 or a.dtype != torch.float32):
        raise TypeError(f"want x and B/C float32 or bfloat16 (B and C alike), dt and a "
                        f"float32; got x {x.dtype}, dt {dt.dtype}, a {a.dtype}, "
                        f"B {bmat.dtype}, C {cmat.dtype}")
    for name, t in (("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def fold_and_scan(x, dt, a, bmat, cmat, *, chunk: int = 256):
    """The plain version in the model layout, on any device: the reference
    wrapper's path with its oracle.  Fold heads into rows (B and C
    broadcast to every head, ``da = dt * a``), ``reference_ssd_scan``,
    unfold; y in x's dtype."""
    b, length, nh, hd = x.shape
    n = bmat.shape[-1]
    nc = length // chunk
    da = dt * a[None, None, :]
    xk = x.transpose(1, 2).reshape(b * nh, nc, chunk, hd)
    dak = da.transpose(1, 2).reshape(b * nh, nc, chunk)
    dtk = dt.transpose(1, 2).reshape(b * nh, nc, chunk)
    bk = bmat[:, None].expand(b, nh, length, n).reshape(b * nh, nc, chunk, n)
    ck = cmat[:, None].expand(b, nh, length, n).reshape(b * nh, nc, chunk, n)
    y, h = reference_ssd_scan(xk, dak, dtk, bk, ck)
    y = y.reshape(b, nh, length, hd).transpose(1, 2)
    return y.to(x.dtype), h.reshape(b, nh, hd, n)


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 256):
    """x: (B,L,nh,hd); dt: (B,L,nh) f32; a: (nh,) f32; bmat, cmat: (B,L,N)
    -> (y (B,L,nh,hd) in x's dtype, h_final (B,nh,hd,N) f32).

    L must be a multiple of ``chunk``.  CUDA tensors go through the kernels
    (hd in {16, 32, 64}, N in {16, 32, 64, 128}, chunk in {16, ..., 256},
    x and B/C f32 or bf16, contiguous); CPU tensors through
    ``reference_ssd_scan``."""
    _check(x, dt, a, bmat, cmat, chunk)
    if x.device.type == "cpu":
        return fold_and_scan(x, dt, a, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got {x.device}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    refuse_grad("ssd_scan", x, dt, a, bmat, cmat)
    b, length, nh, hd = x.shape
    y = torch.empty_like(x)
    h_final = torch.empty((b, nh, hd, bmat.shape[-1]), dtype=torch.float32, device=x.device)
    layout = launch_ssd_scan(x, dt, a, bmat, cmat, y, h_final, chunk=chunk)
    ssd_scan.launches += 1
    ssd_scan.launches_by_layout[layout] = ssd_scan.launches_by_layout.get(layout, 0) + 1
    return y, h_final


ssd_scan.launches = 0
ssd_scan.launches_by_layout = {}  # (heads a block, paired) -> launches
