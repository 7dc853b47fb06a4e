"""ctypes binding of ``csrc/flash_attention.cu`` (counterpart of the
reference's ``kernel.py``, which holds the Pallas ``pallas_call``)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["build", "launch_flash_attention"]

_SOURCE = "flash_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, B, S, T, H, KV, hd, dtype, causal, window, softcap,
    # scale, device, stream
    "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _F, _I, _P]),
    "flash_attention_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Build (once) and load the kernel's library."""
    return load_library(_SOURCE, _SIGNATURES)


def launch_flash_attention(q, k, v, out, *, causal: bool, window: int,
                           softcap: float, scale: float) -> None:
    """Launch the kernel on the current stream of ``q``'s device.  Shapes,
    types, devices and alignment are checked by the caller (``ops``)."""
    lib = build()
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, h, kv, hd, _DTYPE_CODE[q.dtype], int(causal), int(window),
        float(softcap), float(scale), device, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
