"""The paper's own Transformer-Engine Llama configs (Table II / Fig. 5).

hidden sizes {1024, 2048, 4096, 5120, 8192} with the paper's
ffn_hidden_size and head counts; SwiGLU + RMSNorm per §III-C-2.
Used by benchmarks/te_layer.py and benchmarks/llm_gen.py.
"""

from repro_torch.configs.base import ModelConfig

_TABLE_II = {
    1024: (2816, 8),
    2048: (5632, 16),
    4096: (11008, 32),     # llama-7b
    5120: (13824, 40),     # llama-13b
    8192: (22016, 64),     # llama-70b layer shape
}


def te_layer_config(hidden_size: int, num_layers: int = 1) -> ModelConfig:
    ffn, heads = _TABLE_II[hidden_size]
    return ModelConfig(
        name=f"llama-te-h{hidden_size}",
        family="dense",
        num_layers=num_layers,
        d_model=hidden_size,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=ffn,
        vocab_size=32000,
        norm="rmsnorm",
        activation="swiglu",
        source="paper Table II",
    )


# a ~160M llama for application-level generation tests (Table XII analog)
CONFIG = ModelConfig(
    name="llama-te-mini",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=2048,
    vocab_size=32000,
    norm="rmsnorm",
    activation="swiglu",
    source="paper §III-C-3 (reduced)",
)
