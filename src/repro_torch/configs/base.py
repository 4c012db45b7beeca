"""Model/arch, shape-cell and training configuration."""

from __future__ import annotations

import dataclasses
import os
import tempfile


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # SSM
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    conv_width: int = 4
    ssm_head_dim: int = 64         # mamba2 only
    # Hybrid (zamba2): shared attention block applied every `attn_every`
    attn_every: int = 0
    # Enc-dec (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    max_source_len: int = 1500     # encoder frames (whisper stub)
    max_target_len: int = 448      # decoder positions (whisper)
    # Modality frontend stub: none | patch (vlm) | frame (audio)
    frontend: str = "none"
    num_prefix_tokens: int = 0     # vlm patch tokens prepended
    # Norm / act / misc
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    activation: str = "swiglu"     # swiglu | gelu
    use_bias: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: int = 0
    dtype: str = "bfloat16"
    remat: str = "dots"            # none | dots | full
    # citation / provenance
    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid") and not self.d_inner:
            object.__setattr__(self, "d_inner", 2 * self.d_model)
        if self.family == "ssm" and not self.dt_rank:
            object.__setattr__(self, "dt_rank",
                               max(1, self.d_model // 16))

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a TP-friendly multiple (Megatron-style:
        embedding/unembedding shard evenly over 16-way model axes; the
        padded ids are never produced by the tokenizer/data)."""
        mult = 256
        return (self.vocab_size + mult - 1) // mult * mult

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    @property
    def gated(self) -> bool:
        return self.activation == "swiglu"

    def param_count(self) -> int:
        """Analytic N for 6*N*D accounting (embedding included once)."""
        from repro_torch.models import api
        from repro_torch.models.common import count_params
        return count_params(api.param_shapes(self))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatch: int = 0            # 0 = no gradient accumulation
    ckpt_every: int = 100
    # under the temporary directory ($TMPDIR) of the process
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    seed: int = 0
    # distributed-optimization tricks (compression is not ported yet)
    grad_compression: str = "none"   # none | bf16 | int8_ef
    async_ckpt: bool = True
