"""Figs. 8/9 analog: distributed-shared-memory benchmarks.

Thread-block clusters on the card (``core/dsm.py``, ``csrc/dsm.cu``):
the one-hop latency probe, the ring-based copy (RBC) over cluster size
x hops x ILP in GB/s, private vs bin-partitioned (DSM) histograms, and
the all-to-all exchange.  Each rank's payload moves over the SM-to-SM
network; GB/s counts the bytes that cross it (the payload times the
hops).  Measured rows carry the device's label; the paper's H800
points are printed beside them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks import device_label
from repro_torch.core import dsm
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure

RNG = np.random.default_rng(19)


def _gbps(nbytes: float, us: float) -> float:
    return nbytes / (us * 1e-6) / 1e9


@register("dsm", "Figs. 8/9")
def dsm_bench(device):
    rows = []
    label = device_label(device)
    cs = 4

    # latency probe (one hop of one word per rank)
    t = measure(lambda: dsm.ring_latency_probe(cs, device=device),
                name=f"measured({label})/latency_probe_us", warmup=2, reps=5)
    rows.append(t)

    # RBC throughput: hops x ILP at cluster size 4
    x = torch.arange(4 * 65536, dtype=torch.float32,
                     device=device).reshape(4, 65536)
    nbytes = x.numel() * x.element_size()
    for hops in (1, 3):
        for ilp in (1, 4):
            t = measure(lambda h=hops, i=ilp: dsm.rbc_ring_copy(
                x, cs, hops=h, ilp=i),
                name=f"measured({label})/rbc_hops{hops}_ilp{ilp}_GBps",
                warmup=2, reps=5)
            t.derived = _gbps(nbytes * hops, t.us_per_call)
            t.derived_name = "GB/s"
            rows.append(t)

    # histogram: private per block vs bins split over the cluster (DSM)
    vals = torch.from_numpy(RNG.integers(0, 1024, 4 * 32768)).to(
        device=device, dtype=torch.int32)
    for nbins in (1024, 4096):
        t1 = measure(lambda n=nbins: dsm.histogram_private_psum(vals, n, cs),
                     name=f"measured({label})/hist_private_nbins{nbins}",
                     warmup=2, reps=5)
        t2 = measure(lambda n=nbins: dsm.histogram_dsm(vals, n, cs),
                     name=f"measured({label})/hist_dsm_nbins{nbins}",
                     warmup=2, reps=5)
        t2.derived = vals.numel() / (t2.us_per_call * 1e-6) / 1e9
        t2.derived_name = "G_elements_per_s"
        rows.extend([t1, t2])

    # all-to-all exchange over the cluster
    t = measure(lambda: dsm.all_to_all_exchange(x, cs),
                name=f"measured({label})/all_to_all_cs{cs}_GBps",
                warmup=2, reps=5)
    t.derived = _gbps(nbytes, t.us_per_call)
    t.derived_name = "GB/s"
    rows.append(t)

    # cluster size x ILP, 1 MiB a rank, one hop (the grid the reference
    # models for its TPU's links, measured here)
    for size in (2, 4, 8):
        xs = torch.ones((size, 1 << 18), dtype=torch.float32, device=device)
        for ilp in (1, 4):
            t = measure(lambda v=xs, s=size, i=ilp: dsm.rbc_ring_copy(
                v, s, hops=1, ilp=i),
                name=f"measured({label})/rbc_cs{size}_ilp{ilp}",
                warmup=2, reps=5)
            t.derived = _gbps(xs.numel() * xs.element_size(), t.us_per_call)
            t.derived_name = "GB/s"
            rows.append(t)
    # paper reference: 3.27 TB/s at CS=2 -> 2.65 TB/s at CS=4 (contention)
    rows.append(Timing("paper/H800/rbc_cs2_TBps", 0, 0, 1, derived=3.27))
    rows.append(Timing("paper/H800/rbc_cs4_TBps", 0, 0, 1, derived=2.65))
    return rows
