"""Benchmark of the PyTorch and CUDA port (``src/repro_torch``) on one H100.

``python3 gpu_bench/run.py --workload <config>.<mix> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

  configs/<config>.json    the model as it is run, its source and cuts
  traffic/<mix>.json       the traffic, the engine and policy settings
  drivers/<driver>.py      the code that drives a mix (``serve``)
  metrics/<metric>.py      a metric's reader (or ``<name before the dot>.py``)
  limits/<cell>.json       the limit of each number the check compares
  reference/<module>.py    a configuration's plain float32 reference

``bench/`` holds the shared yardstick: the traffic generator, the seeded
weights, the roofline arithmetic, the profiler reductions and the check.
Nothing here imports jax, jaxlib, flax, ``repro`` or ``benchmarks``.
"""
