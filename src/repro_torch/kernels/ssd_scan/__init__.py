from .ops import reference_ssd_scan, ssd_scan  # noqa: F401
