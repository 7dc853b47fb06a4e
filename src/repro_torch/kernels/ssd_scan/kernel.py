"""ctypes binding of ``csrc/ssd_scan.cu`` (counterpart of the reference's
``kernel.py``, which holds the Pallas ``pallas_call``)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["build", "launch_ssd_scan"]

_SOURCE = "ssd_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, hd, N, chunk,
    # x dtype, B/C dtype, device, layout (2 ints out), stream
    "ssd_scan_fwd": (_I, [_P] * 9 + [_I] * 9 + [ctypes.POINTER(_I), _P]),
    "ssd_scan_error_string": (ctypes.c_char_p, [_I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build(source: str = _SOURCE):
    """Build (once) and load the kernel's library; ``source`` may name
    another file with the same C interface (an absolute path), for an A/B
    of two versions of the kernels in one process."""
    return load_library(source, _SIGNATURES)


def launch_ssd_scan(x, dt, a, bmat, cmat, y, h_final, *, chunk: int,
                    lib=None) -> tuple[int, int]:
    """Launch the three kernels (chunk states, state pass, chunk outputs) on
    the current stream of ``x``'s device (``lib``, default this checkout's
    library); returns the chunk outputs' block layout, (heads a block, 1 if
    a block takes a pair of row tiles else 0).  Shapes, types, devices and
    alignment are checked by the caller (``ops``)."""
    lib = build() if lib is None else lib
    b, length, nh, hd = x.shape
    n = bmat.shape[-1]
    nc = length // chunk
    states = torch.empty((b * nh, nc, hd, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((b * nh, nc), dtype=torch.float32, device=x.device)
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    layout = (_I * 2)()
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), states.data_ptr(), decay.data_ptr(),
        b, length, nh, hd, n, chunk, _DTYPE_CODE[x.dtype], _DTYPE_CODE[bmat.dtype],
        device, layout, stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({err})")
    return layout[0], layout[1]
