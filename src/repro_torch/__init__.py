"""repro_torch — the Metronome serving stack in PyTorch, for one NVIDIA H100.

A second package beside ``repro`` (the JAX reference).  Its layout mirrors
``repro`` so each module's counterpart is easy to find:

  core/      host-side retrieval control (copies of ``repro.core``)
  runtime/   policies, queues, workloads and the threaded ``Runtime``
  configs/   ``ModelConfig`` and the gemma-2b / gemma2-2b configs
  models/    layers, attention and the dense transformer stack
  kernels/   hand-written CUDA kernels, each beside its plain PyTorch twin
  serving/   the continuous-batching engine and the ``Server`` front
  launch/    ``python -m repro_torch.launch.serve``

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
where CUDA is missing they raise instead of falling back.  This package
imports torch, numpy and the standard library, never jax and never a
module of ``repro``.
"""
