"""Reparameterizations of the sampler's space (normalizing flows)."""

from .flow import FlowConfig, FlowParams, FlowWindow

__all__ = ["FlowConfig", "FlowParams", "FlowWindow"]
