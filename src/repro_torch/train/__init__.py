"""Training, PyTorch port of ``repro.train`` on one device: AdamW, the
loss and train step (remat, gradient accumulation), the deterministic
data pipeline, checkpoints, the fault-tolerant loop and int8
quantization.  The reference's multi-device ``compressed_psum_int8`` and
``make_dp_grad_fn`` are not part of the port."""

from .checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .compression import dequantize_int8, quantize_int8  # noqa: F401
from .data import HostPrefetcher, TokenDataset  # noqa: F401
from .loop import train_loop  # noqa: F401
from .optimizer import OptConfig, apply_updates, global_norm, init_opt  # noqa: F401
from .steps import (  # noqa: F401
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
