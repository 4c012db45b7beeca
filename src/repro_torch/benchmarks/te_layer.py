"""Fig. 5 / Table II: te_transformer_layer latency per hidden size.

The paper's Table II layer shapes (``configs/llama_te.te_layer_config``:
SwiGLU, RMSNorm, head_dim 128) through ``te_transformer_layer`` (every
linear through ``te_linear`` in e4m3 with delayed scaling, attention in
bf16 through ``flash_attention``, the CUDA kernel B9 on the card) and,
as the bf16 baseline, the same block through
``models/transformer.layer_fwd``.  On the card the paper's batch 4 x
sequence 512 at all five hidden sizes; on the CPU the reference's
reduced 2 x 128 at 1024 and 2048.  Rows: us a call, and the paper's
finding (fp8 beats 16-bit only above hidden 4096).
"""

from __future__ import annotations

import torch

from repro_torch.benchmarks import device_label
from repro_torch.configs.llama_te import te_layer_config
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure
from repro_torch.models import transformer
from repro_torch.models.common import init_params
from repro_torch.te.fp8 import DelayedScalingRecipe
from repro_torch.te.layer import (te_transformer_layer,
                                  transformer_layer_specs,
                                  transformer_layer_state)

CPU_SHAPE, CPU_HIDDEN = (2, 128), (1024, 2048)
CARD_SHAPE, CARD_HIDDEN = (4, 512), (1024, 2048, 4096, 5120, 8192)


def _params(specs, seed: int, device):
    return init_params(specs, torch.Generator(device=device).manual_seed(seed),
                       device, torch.float32)


@register("te_layer", "Fig. 5 / Table II")
def te_layer_latency(device):
    device = torch.device(device)
    label = device_label(device)
    rows = []
    recipe = DelayedScalingRecipe()
    on_card = device.type == "cuda"
    B, S = CARD_SHAPE if on_card else CPU_SHAPE
    gen = torch.Generator(device=device).manual_seed(11)
    for hidden in CARD_HIDDEN if on_card else CPU_HIDDEN:
        cfg = te_layer_config(hidden)
        params = _params(transformer_layer_specs(cfg), 0, device)
        state = transformer_layer_state(cfg, recipe, device)
        x = torch.randn((B, S, hidden), generator=gen,
                        device=device).to(torch.bfloat16)
        _, state = te_transformer_layer(cfg, params, state, x, recipe)
        rows.append(measure(
            lambda: te_transformer_layer(cfg, params, state, x, recipe),
            name=f"measured({label})/fp8/h{hidden}", warmup=1, reps=4))
        del params, state

        # bf16 baseline: the same block through the model's layer
        lp = _params(transformer.layer_specs(cfg), 1, device)
        pos = torch.arange(S, device=device).expand(B, S)
        rows.append(measure(lambda: transformer.layer_fwd(cfg, lp, x, pos)[0],
                            name=f"measured({label})/bf16/h{hidden}",
                            warmup=1, reps=4))
        del lp
    # the paper's finding: fp8 beats 16-bit only for hidden > 4096
    rows.append(Timing("paper/fp8_wins_above_hidden", 0, 0, 1, derived=4096))
    return rows
