"""The paper's dissection benchmarks on the port's kernels.

``python -m repro_torch.benchmarks.run`` runs the registered ones.
"""

from __future__ import annotations

import re

import torch


def device_label(device) -> str:
    """The device's name in row labels: ``cpu``, or the GPU's model
    (``h100`` for an NVIDIA H100), or ``gpu`` when the name has none."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    found = re.search(r"\b([A-Z]{1,2}\d{2,4})\b", name)
    return found.group(1).lower() if found else "gpu"


def tflops(flops: float, us: float) -> float:
    """FLOP/s over a call of `us` microseconds, in TFLOP/s."""
    return flops / (us * 1e-6) / 1e12
