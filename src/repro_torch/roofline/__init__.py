"""Roofline terms on the H100's data-sheet rates (``analysis``), the cost
counter that feeds them (``cost``), and each hand-written kernel's work
formula (``kernels``)."""
from repro_torch.roofline.analysis import (HW, active_params, count_params,
                                           model_flops, roofline_terms)
from repro_torch.roofline.cost import CostCounter

__all__ = ["HW", "CostCounter", "active_params", "count_params",
           "model_flops", "roofline_terms"]
