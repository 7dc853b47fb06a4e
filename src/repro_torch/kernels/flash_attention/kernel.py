"""ctypes binding of ``csrc/flash_attention.cu`` (counterpart of the
reference's ``kernel.py``, which holds the Pallas ``pallas_call``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library

__all__ = ["BF16_KERNELS", "bf16_rows", "build", "launch_flash_attention"]

_SOURCE = "flash_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, B, S, T, H, KV, hd, dtype, causal, window, softcap,
    # scale, device, stream
    "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _F, _I, _P]),
    # q, k, v, out, B, S, T, H, KV, hd, rows, causal, window, softcap,
    # scale, device, stream: the bf16 kernel of ``rows`` q rows a block
    "flash_attention_bf16_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _F, _F, _I, _P]),
    # B, S, H, hd -> the q rows a block of the bf16 kernel the entry point
    # launches for that shape
    "flash_attention_bf16_rows": (_I, [_I, _I, _I, _I]),
    "flash_attention_error_string": (ctypes.c_char_p, [_I]),
}
# q rows a block -> the bf16 kernel that takes them (csrc/flash_attention.cu)
BF16_KERNELS = {64: "flash_fwd_wgmma_bf16", 128: "flash_fwd_pingpong_bf16"}
# the C entry point picks the kernel by this code: 0 -> f32 as split TF32
# on mma.sync, 1 -> bf16 on wgmma (ops.ROUTES names the two routes)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# what every version of the source has exported (an A/B against an older
# one binds these alone)
_AB_SIGNATURES = {n: _SIGNATURES[n] for n in ("flash_attention_fwd",
                                              "flash_attention_error_string")}


def build(source: str = _SOURCE):
    """Build (once) and load the kernel's library; ``source`` may name
    another file with ``flash_attention_fwd``'s C interface (an absolute
    path), for an A/B of two versions of the kernel in one process."""
    return load_library(source, _SIGNATURES if source == _SOURCE else _AB_SIGNATURES)


@functools.lru_cache(maxsize=256)
def bf16_rows(b: int, s: int, h: int, hd: int) -> int:
    """q rows a block (a key of ``BF16_KERNELS``) of the bf16 kernel that
    this checkout's entry point launches at this shape: the source's rule."""
    return build().flash_attention_bf16_rows(b, s, h, hd)


def launch_flash_attention(q, k, v, out, *, causal: bool, window: int,
                           softcap: float, scale: float, lib=None, rows: int | None = None) -> None:
    """Launch the kernel on the current stream of ``q``'s device (``lib``,
    default this checkout's library).  ``rows`` picks the bf16 kernel by its
    q rows a block (64 or 128, hd 128) past the source's rule, for timing
    both; by default the entry point applies the rule.  Shapes, types,
    devices and alignment are checked by the caller (``ops``)."""
    lib = build() if lib is None else lib
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (int(causal), int(window), float(softcap), float(scale), device, stream)
    if rows is None:
        err = lib.flash_attention_fwd(*ptrs, b, s, t, h, kv, hd, _DTYPE_CODE[q.dtype], *tail)
    elif q.dtype != torch.bfloat16:
        raise ValueError(f"rows= picks a bf16 kernel; got {q.dtype}")
    else:
        err = lib.flash_attention_bf16_fwd(*ptrs, b, s, t, h, kv, hd, int(rows), *tail)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
