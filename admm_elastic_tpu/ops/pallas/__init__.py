"""Pallas GPU kernels (Triton route)."""

from .nh_local import nh_local_step, nh_local_step_fused

__all__ = ["nh_local_step", "nh_local_step_fused"]
