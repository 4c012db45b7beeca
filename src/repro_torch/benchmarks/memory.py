"""Tables IV & V: memory-hierarchy latency and throughput.

On the card (``kernels/memory.py``, ``csrc/memory.cu``) the paper's own
levels, by its method:
  * Table IV: a pointer chase of dependent 8-byte loads through L1
    (``ld.global.ca``, 16 KB), shared memory (16 KB), L2 (``.cg``, 8 MB:
    above the 256 KB L1, below the 50 MB L2) and device memory (``.cg``,
    1 GB), in SM cycles a hop with the ns of ``%globaltimer`` beside
    them (us_per_call is ns / 1000 a hop);
  * Table V: the stream ``y = 2x + 1`` in GB/s (bytes read + written)
    from L2 (8 MB, 256 passes) and from device memory (2 GB), and the
    bytes a clock an SM that one block an SM reads from L1 and from
    shared memory, and the L2 / device-memory ratio (us_per_call is
    the time of a call).
On the card each kernel is held to its plain version exactly (the
chase's last index, the stream's bits, the on-chip checksums); a
difference raises.
On the CPU the reference's host rows (``hostL1`` ... ``hostDRAM``)
through the plain versions (host clock).  The paper's A100, RTX4090
and H800 rows are printed beside them.  The reference's ``model(v5e)``
rows (VREG, VMEM, HBM cycles; VMEM bytes a clock; VMEM / HBM) are TPU
constants with no H100 counterpart: the measured rows take their place,
and ``model(<target>)/hbm`` is the H100's data-sheet rate.
"""

from __future__ import annotations

import statistics

import torch

from repro_torch.benchmarks import device_label
from repro_torch.core import hw
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure
from repro_torch.kernels import memory

# Table IV on the card: row, load, chain bytes
LEVELS = (("L1", "ca", 16 << 10), ("shared", "shared", 16 << 10),
          ("L2", "cg", 8 << 20), ("global", "cg", 1 << 30))
LATENCY_ITERS = 1 << 15
# a chain up to this many entries (32 MB, within L2) is walked once
# whole before the timed hops; a longer one outgrows L2 and warms with
# `iters` hops
WHOLE_WARM_ENTRIES = 1 << 22
# Table V on the card: row, float32 bytes of x, passes
STREAMS = (("L2", 8 << 20, 256), ("global", 2 << 30, 1))
ONCHIP = (("L1", "l1"), ("shared", "shared"))
ONCHIP_REPS = 8192
# the reference's host rows
HOST_LATENCY = (("hostL1", 16 << 10), ("hostL2", 256 << 10),
                ("hostLLC", 8 << 20), ("hostDRAM", 256 << 20))
HOST_LATENCY_ITERS = 1 << 16
HOST_STREAMS = (("hostL2", 256 << 10), ("hostLLC", 8 << 20),
                ("hostDRAM", 512 << 20))
# the paper's Table IV (cycles: L1, shared, L2, global) and Table V
PAPER_LATENCY = (("A100", (37.9, 29.0, 261.5, 466.3)),
                 ("RTX4090", (43.4, 30.1, 273.0, 541.5)),
                 ("H800", (40.7, 29.0, 263.0, 478.8)))
PAPER_GLOBAL_GBPS = (("RTX4090", 929.8), ("A100", 1407.2), ("H800", 1861.5))


def warm_hops(n: int, iters: int) -> int:
    return n if n <= WHOLE_WARM_ENTRIES else iters


def chase(size_bytes: int, load: str, device, iters: int,
          warm=None) -> tuple:
    """(cycles, ns) a hop of the chain of `size_bytes` on `device`.  On
    the card the last index is held to the host walk's (the proof that
    the kernel walked the chain); it raises if they differ."""
    nxt = memory.pointer_chain(size_bytes)
    chain = torch.tensor(nxt, device=device)
    warm = warm_hops(len(nxt), iters) if warm is None else warm
    last, cycles, ns = memory.pchase(chain, load, iters=iters,
                                     warm=warm).tolist()
    if device.type == "cuda":
        want = int(memory.pchase_plain(chain, warm, iters)[0])
        if last != want:
            raise RuntimeError(f"pchase {load} {size_bytes} B: last index "
                               f"{last}, the host walk's {want}")
    return cycles / iters, ns / iters


def stream_rate(size_bytes: int, passes: int, device) -> tuple:
    """(us a call, GB/s read + written) of `passes` passes of the stream
    over `size_bytes` of float32.  On the card the output is held
    bitwise to ``x * 2 + 1``; it raises if it differs."""
    x = torch.arange(size_bytes // 4, dtype=torch.float32, device=device)
    t = measure(lambda: memory.stream(x, passes), name="stream", warmup=2,
                reps=5)
    if device.type == "cuda":
        y, want = memory.stream(x, passes), memory.stream_plain(x)
        if not torch.equal(y.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"stream {size_bytes} B: not bitwise x * 2 + 1")
    gbps = 2 * size_bytes * passes / (t.us_per_call * 1e-6) / 1e9
    return t.us_per_call, gbps


def onchip_rate(mode: str, device) -> tuple:
    """(us a call, bytes a clock an SM): the median block's 16 KB x reps
    over its cycles.  The checksums are held to the plain version's; it
    raises if they differ."""
    src = torch.arange(memory.BW_WORDS, dtype=torch.int32, device=device)
    t = measure(lambda: memory.onchip_bw(src, mode, reps=ONCHIP_REPS),
                name="onchip_bw", warmup=1, reps=5)
    sums, cycles = memory.onchip_bw(src, mode, reps=ONCHIP_REPS)
    want, _ = memory.onchip_bw_plain(src, ONCHIP_REPS, sums.numel())
    if not torch.equal(sums.cpu(), want):
        raise RuntimeError(f"onchip_bw {mode}: checksums differ from the "
                           f"plain version's")
    per_block = statistics.median(cycles.tolist())
    return t.us_per_call, ONCHIP_REPS * 4 * memory.BW_WORDS / per_block


@register("memory_latency", "Table IV")
def latency_table(device):
    device = torch.device(device)
    rows = []
    if device.type == "cuda":
        label = device_label(device)
        for name, load, size in LEVELS:
            cyc, ns = chase(size, load, device, LATENCY_ITERS)
            rows.append(Timing(f"measured({label})/{name}", ns * 1e-3, 0, 1,
                               derived=cyc, derived_name="cycles"))
    else:
        for name, size in HOST_LATENCY:
            _, ns = chase(size, "cg", device, HOST_LATENCY_ITERS, warm=0)
            rows.append(Timing(f"measured(cpu)/{name}", ns * 1e-3, 0, 1,
                               derived=ns, derived_name="ns"))
    for gpu, vals in PAPER_LATENCY:
        for lvl, cyc in zip(("L1", "shared", "L2", "global"), vals):
            rows.append(Timing(f"paper/{gpu}/{lvl}", 0.0, 0, 1,
                               derived=cyc, derived_name="cycles"))
    return rows


@register("memory_throughput", "Table V")
def throughput_table(device):
    device = torch.device(device)
    rows = []
    gbps = {}
    if device.type == "cuda":
        label = device_label(device)
        for name, size, passes in STREAMS:
            us, gbps[name] = stream_rate(size, passes, device)
            rows.append(Timing(f"measured({label})/{name}", us, 0, 1,
                               derived=gbps[name], derived_name="GB/s"))
        for name, mode in ONCHIP:
            us, rate = onchip_rate(mode, device)
            rows.append(Timing(
                f"measured({label})/{name}_bytes_per_clk_per_sm", us, 0, 1,
                derived=rate))
    else:
        for name, size in HOST_STREAMS:
            us, rate = stream_rate(size, 1, device)
            rows.append(Timing(f"measured(cpu)/{name}", us, 0, 1,
                               derived=rate, derived_name="GB/s"))
    rows.append(Timing(f"model({hw.TARGET.name})/hbm", 0.0, 0, 1,
                       derived=hw.TARGET.hbm_gbps, derived_name="GB/s"))
    for gpu, glob in PAPER_GLOBAL_GBPS:
        rows.append(Timing(f"paper/{gpu}/global", 0.0, 0, 1, derived=glob,
                           derived_name="GB/s"))
    # the paper's finding: L2 / global 4.67 (RTX4090), 2.01 (A100), 4.23
    # (H800)
    if gbps:
        rows.append(Timing(f"measured({label})/l2_vs_global_ratio", 0.0, 0,
                           1, derived=gbps["L2"] / gbps["global"]))
    return rows
