"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free.
[arXiv:2410.05355; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_inner=8192,          # expand=2
    dt_rank=256,           # d_model/16
    conv_width=4,
    norm="rmsnorm",
    source="arXiv:2410.05355",
)
