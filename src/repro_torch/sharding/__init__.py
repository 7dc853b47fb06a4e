from .logical import logical_axis_rules, shard  # noqa: F401
