"""Builtin models of this slice: the radon benchmark model.

The analytic test posteriors and the logistic GLM of
``nutpie_tpu/models`` are still to be ported (ROADMAP queue 1).
"""

from .radon import radon

__all__ = ["radon"]
