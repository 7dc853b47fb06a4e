from .analysis import (  # noqa: F401
    HW,
    CellReport,
    CostTrace,
    analyze_cell,
    collective_bytes,
    model_flops,
    roofline_terms,
)
