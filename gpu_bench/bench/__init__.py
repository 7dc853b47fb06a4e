"""The benchmark's shared yardstick (see ``gpu_bench/__init__.py``)."""
