"""Config registry: the 10 assigned architectures + paper-native configs.

``get_config(name)`` returns the exact published config;
``reduced_config(name)`` returns a same-family CPU-smoke-test config
(small layers/width, few experts, tiny vocab) for tests and examples.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa: F401
                                      ShapeConfig)

from repro_torch.configs import (codeqwen15_7b, command_r_35b, dbrx_132b,
                           deepseek_coder_33b, falcon_mamba_7b,
                           internvl2_1b, llama_te, moonshot_v1_16b_a3b,
                           whisper_small, yi_6b, zamba2_27b)

_REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (command_r_35b, deepseek_coder_33b, codeqwen15_7b, yi_6b,
              dbrx_132b, moonshot_v1_16b_a3b, falcon_mamba_7b,
              internvl2_1b, whisper_small, zamba2_27b, llama_te)
}

ASSIGNED: List[str] = [
    "command-r-35b", "deepseek-coder-33b", "codeqwen1.5-7b", "yi-6b",
    "dbrx-132b", "moonshot-v1-16b-a3b", "falcon-mamba-7b", "internvl2-1b",
    "whisper-small", "zamba2-2.7b",
]


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return list(ASSIGNED)


def reduced_config(name: str) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests."""
    cfg = get_config(name)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kvh = (min(cfg.num_kv_heads, heads) if cfg.num_kv_heads else 0)
    if heads and kvh and heads % kvh:
        kvh = 1
    upd = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kvh,
        head_dim=(16 if heads else 0),
        d_ff=(128 if cfg.d_ff else 0),
        vocab_size=256,
        remat="none",
    )
    if cfg.family == "moe":
        upd.update(num_experts=4, top_k=2)
    if cfg.family in ("ssm", "hybrid"):
        upd.update(ssm_state=8, d_inner=128, dt_rank=8, ssm_head_dim=16)
    if cfg.family == "hybrid":
        upd.update(num_layers=4, attn_every=2)
    if cfg.family == "encdec":
        upd.update(enc_layers=2, dec_layers=2, max_source_len=32,
                   max_target_len=16)
    if cfg.family == "vlm":
        upd.update(num_prefix_tokens=4)
    return dataclasses.replace(cfg, **upd)


def reduced_shape(kind: str = "train") -> ShapeConfig:
    """A CPU-smoke cell of `kind` (train | prefill | decode): 2 x 32."""
    if kind == "train":
        return ShapeConfig("train_smoke", 32, 2, "train")
    if kind == "prefill":
        return ShapeConfig("prefill_smoke", 32, 2, "prefill")
    return ShapeConfig("decode_smoke", 32, 2, "decode")
