"""ctypes binding of ``csrc/decode_attention.cu`` (counterpart of the
reference's ``kernel.py``, which holds the Pallas ``pallas_call``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library

__all__ = ["build", "launch_decode_attention", "piece_len", "PIECES"]

_SOURCE = "decode_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, pos, out, scratch, B, T, H, KV, hd, dtype, piece_len, window,
    # softcap, scale, device, stream
    "decode_attention_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _I, _P]),
    "decode_attention_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GROUP_MAX = 8   # query heads one block serves (GMAX in the source)
PIECES = (64, 128, 256, 512)   # positions per block that piece_len chooses from


def build():
    """Build (once) and load the kernel's library."""
    return load_library(_SOURCE, _SIGNATURES)


def piece_len(b: int, h: int, kv: int, t: int, sms: int) -> int:
    """Positions per block for B=b, H=h, KV=kv and T=t on a card with
    ``sms`` SMs: the largest of ``PIECES`` that still gives one block per
    SM, else the smallest.  Longer pieces leave the combine fewer partials
    to walk; shorter ones fill more SMs."""
    blocks_per_piece = b * kv * -(-(h // kv) // _GROUP_MAX)
    for piece in reversed(PIECES):
        if blocks_per_piece * -(-t // piece) >= sms:
            return piece
    return PIECES[0]


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_decode_attention(q, k, v, pos, out, *, window: int, softcap: float,
                            scale: float, piece: int | None = None) -> None:
    """Launch split and combine on the current stream of ``q``'s device,
    with ``piece`` positions per block (by default ``piece_len``'s choice).
    Shapes, types, devices and alignment are checked by the caller
    (``ops``); ``pos`` is int32."""
    lib = build()
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if piece is None:
        piece = piece_len(b, h, kv, t, _sm_count(device))
    n_pieces = -(-t // piece)
    scratch = torch.empty(b * h * n_pieces * (hd + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, t, h, kv, hd, _DTYPE_CODE[q.dtype], piece, int(window),
        float(softcap), float(scale), device, stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} ({err})")
