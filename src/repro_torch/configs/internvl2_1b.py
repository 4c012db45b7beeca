"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]
Backbone only per the assignment; `input_specs()` provides precomputed
patch embeddings as `prefix_embeds`."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend="patch",
    num_prefix_tokens=256,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2404.16821",
)
