"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=50000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
