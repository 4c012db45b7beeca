"""Transformer Engine analog: FP8 numerics + fused layers (paper §III-C)."""

from repro_torch.te.fp8 import E4M3, E5M2, DelayedScalingRecipe  # noqa: F401
from repro_torch.te.linear import te_linear, fp8_matmul          # noqa: F401
