"""Transformer Engine analog: fp8 numerics and the fp8 serving linears."""
