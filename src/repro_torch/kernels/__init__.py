"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of
``repro.kernels`` on the port's path so far.

Each kernel ships as ``<name>/`` with ``ops.py`` (the public wrapper, its
launch counter and the plain PyTorch version it is held against) and
``kernel.py`` (the ctypes binding of ``csrc/<name>.cu``).  A wrapper uses
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  The CUDA source is compiled at first use (``_build``),
never at import.
"""

from .flash_attention import flash_attention, flash_attention_ref  # noqa: F401
