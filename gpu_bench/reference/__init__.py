"""Plain float32 references of the benchmark's configurations.

Each module here imports torch and ``gpu_bench.bench.weights`` alone: not
jax, not ``repro``, not ``repro_torch``.  A configuration file names its
module under ``"reference"``.
"""
