"""Roofline analysis from the dry-run's meta-device traces."""

from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    Hardware,
    RooflineTerms,
    fit_check,
    roofline_from_counts,
)
from repro_torch.roofline.cost import Cost, CostCounter  # noqa: F401
