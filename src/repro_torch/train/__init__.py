"""Training, PyTorch port of ``repro.train``: AdamW, the loss and train
step (remat, gradient accumulation), the deterministic data pipeline,
checkpoints (restored onto a device or resharded onto a mesh), the
fault-tolerant loop, int8 quantization and the int8-compressed
data-parallel gradient (``compressed_psum_int8``, ``make_dp_grad_fn``)."""

from .checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .compression import (  # noqa: F401
    compressed_psum_int8,
    dequantize_int8,
    make_dp_grad_fn,
    quantize_int8,
)
from .data import HostPrefetcher, TokenDataset  # noqa: F401
from .loop import train_loop  # noqa: F401
from .optimizer import OptConfig, apply_updates, global_norm, init_opt  # noqa: F401
from .steps import (  # noqa: F401
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
