"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of
``repro.kernels``: flash attention (K1), decode attention (K2) and the
Mamba2 SSD chunk scan (K3); and one per ``lax.scan`` engine of
``repro.runtime`` ported so far: the fixed-slot sweep (S1, ``slot_sweep``)
and the event-jump sweep (S2, ``adaptive_sweep``), the two steppings of
``repro_torch.runtime.simulate_batch``, and the fixed-slot fleet sweep (S3,
``fleet_sweep``) of ``repro_torch.runtime.simulate_fleet``.

Each kernel ships as ``<name>/`` with ``ops.py`` (the public wrapper, its
launch counter and the plain PyTorch version it is held against) and
``kernel.py`` (the ctypes binding of ``csrc/<name>.cu``).  A wrapper uses
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  The CUDA source is compiled at first use (``_build``),
never at import.
"""

from .adaptive_sweep import adaptive_sweep, reference_adaptive_sweep  # noqa: F401
from .decode_attention import decode_attention, reference_decode_attention  # noqa: F401
from .flash_attention import flash_attention, flash_attention_ref  # noqa: F401
from .fleet_sweep import fleet_sweep, reference_fleet_sweep  # noqa: F401
from .slot_sweep import reference_slot_sweep, slot_sweep  # noqa: F401
from .ssd_scan import reference_ssd_scan, ssd_scan  # noqa: F401
