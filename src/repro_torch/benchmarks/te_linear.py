"""Figs. 3/4: te_linear throughput across sizes, bf16 against fp8.

``measured(<device>)`` rows time ``linear_reference`` (bf16, the layer
TE replaces) and ``te_linear`` (e4m3 forward with delayed scaling: the
amax and quantize passes, the fp8 product, the state update) at N x N x
N, in GFLOP/s; ``model(<target>)`` rows are the tile model's prediction
for the H100 (``core/mxu_model.pick_tile``), in TFLOP/s.  On the card N
runs over the reference's 256, 512 and 1024 and doubles on to 16384,
so both ends of the paper's finding show (small N loses to conversion
overhead, large N wins ~2x on Hopper); on the CPU the reference's three
sizes.  On the card each size also gets ``.../graph`` rows: the same
calls captured in one CUDA graph and replayed (device time, no host
time between launches), which tell dispatch cost from device work.
Also the quantize-overhead fraction at N=512 (paper Fig. 3):
two quantize passes over one te_linear call.
"""

from __future__ import annotations

import torch

from repro_torch.benchmarks import device_label
from repro_torch.core import hw, mxu_model
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure, measure_graph
from repro_torch.models.common import init_params
from repro_torch.te import fp8
from repro_torch.te.fp8 import DelayedScalingRecipe
from repro_torch.te.linear import (init_state, linear_reference, te_linear,
                                   te_linear_specs)

CPU_SIZES = (256, 512, 1024)
CARD_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)


def layer_inputs(n: int, device) -> tuple:
    """(params, x): the float32 N x N weight by the reference's init rule
    (seed 0) and a bf16 [N, N] standard normal input (seed 5)."""
    params = init_params(te_linear_specs(n, n),
                         torch.Generator(device=device).manual_seed(0),
                         device, torch.float32)
    x = torch.randn((n, n), generator=torch.Generator(device=device)
                    .manual_seed(5), device=device).to(torch.bfloat16)
    return params, x


@register("te_linear", "Fig. 4")
def te_linear_throughput(device):
    device = torch.device(device)
    label = device_label(device)
    rows = []
    recipe = DelayedScalingRecipe()
    chip = hw.TARGET
    on_card = device.type == "cuda"
    for n in CARD_SIZES if on_card else CPU_SIZES:
        params, x = layer_inputs(n, device)
        flops = 2.0 * n ** 3
        st = init_state(recipe, device)
        _, st = te_linear(params, st, x, recipe)       # warm scales
        for tag, fn in (("bf16", lambda: linear_reference(params, x)),
                        ("fp8", lambda: te_linear(params, st, x, recipe))):
            name = f"measured({label})/{tag}/N{n}"
            timed = [measure(fn, name=name, warmup=2, reps=5)]
            if on_card:
                timed.append(measure_graph(fn, name=f"{name}/graph",
                                           calls=3 if n >= 8192 else 20))
            for t in timed:
                t.derived = flops / (t.us_per_call * 1e-6) / 1e9
                t.derived_name = "GFLOPs"
                rows.append(t)

        for dt, name in (("bfloat16", "bf16"), ("float8_e4m3fn", "fp8")):
            m = mxu_model.pick_tile(n, n, n, dt, chip)
            rows.append(Timing(f"model({chip.name})/{name}/N{n}", 0.0, 0, 1,
                               derived=m.predicted_flops_per_s / 1e12,
                               derived_name="TFLOPs"))
        del params, x
    # Fig. 3: the share of a te_linear call spent in quantize passes
    n = 512
    params, x = layer_inputs(n, device)
    sx = torch.ones((), dtype=torch.float32, device=device)
    tq = measure(lambda: fp8.quantize(x, sx), name="quantize_only",
                 warmup=2, reps=5)
    st = init_state(recipe, device)
    tt = measure(lambda: te_linear(params, st, x, recipe),
                 name="te_linear_total", warmup=2, reps=5)
    rows.append(Timing(f"measured({label})/quantize_fraction_N512", 0.0, 0,
                       1, derived=2 * tq.us_per_call / tt.us_per_call))
    return rows
