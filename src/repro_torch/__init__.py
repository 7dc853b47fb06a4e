"""repro_torch — the Metronome serving and training stack in PyTorch, for
one NVIDIA H100.

A second package beside ``repro`` (the JAX reference).  Its layout mirrors
``repro`` so each module's counterpart is easy to find:

  core/      host-side retrieval control (copies of ``repro.core``)
  runtime/   policies, queues, workloads, the threaded ``Runtime``, the
             event engine, the batched and fleet sweeps and calibration
  configs/   ``ModelConfig`` and the reference's ten model configs
  models/    layers, attention, Mamba2, MoE and the stub frontends; the
             dense, gemma2, MoE, SSM, hybrid and encoder-decoder stacks
  kernels/   hand-written CUDA kernels, each beside its plain PyTorch twin
  serving/   the continuous-batching engine and the ``Server`` front
  train/     AdamW, the loss and train step (remat, accumulation), data,
             checkpoints, the fault-tolerant loop, int8 quantization
  launch/    ``python -m repro_torch.launch.serve`` and ``.launch.train``

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
where CUDA is missing they raise instead of falling back.  This package
imports torch, numpy and the standard library, never jax and never a
module of ``repro``.
"""
