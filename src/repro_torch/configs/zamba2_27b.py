"""zamba2-2.7b [hybrid] — Mamba-2 stack + shared attention blocks.
[arXiv:2411.15242; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    d_inner=5120,           # expand=2
    ssm_head_dim=64,
    conv_width=4,
    attn_every=6,           # shared attn block every 6 mamba2 layers
    norm="rmsnorm",
    activation="gelu",
    rope_theta=10000.0,
    source="arXiv:2411.15242",
)
