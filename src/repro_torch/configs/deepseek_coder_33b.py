"""deepseek-coder-33b [dense] — llama-arch GQA. [arXiv:2401.14196; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=100000.0,
    source="arXiv:2401.14196",
)
