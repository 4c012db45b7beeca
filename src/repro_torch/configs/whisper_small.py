"""whisper-small [audio] — enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]
`input_specs()` provides precomputed frame embeddings; seq_len of a
shape cell is the *source* frame count (clamped to max_source_len),
decoder runs at max_target_len=448 (DESIGN.md §Arch-applicability)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=24,          # 12 enc + 12 dec
    enc_layers=12,
    dec_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    max_source_len=1500,
    max_target_len=448,
    frontend="frame",
    norm="layernorm",
    activation="gelu",
    use_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
