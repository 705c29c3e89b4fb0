"""Builtin models: the radon benchmark model and the analytic posteriors."""

from .analytic import (
    eight_schools,
    funnel,
    hierarchical_funnel,
    ill_conditioned_gaussian,
    logistic_glm,
    std_normal,
    student_t_funnel,
)
from .radon import radon

__all__ = [
    "eight_schools",
    "funnel",
    "hierarchical_funnel",
    "ill_conditioned_gaussian",
    "logistic_glm",
    "radon",
    "std_normal",
    "student_t_funnel",
]
