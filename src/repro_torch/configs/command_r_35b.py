"""command-r-35b [dense] — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
Note: the HF model uses Cohere's parallel attn+MLP block and LayerNorm;
we keep LayerNorm and model the standard sequential pre-norm block
(DESIGN.md §Arch-applicability)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    activation="swiglu",
    use_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
