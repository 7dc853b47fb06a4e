"""One-off tools of the benchmark: the knee sweep and the check's readings."""
