"""Distributed shared memory (paper §III-D-3, Figs. 8-9) on the H100.

Hopper's DSM lets the blocks of a thread-block cluster read and write
each other's shared memory over the SM-to-SM network.  Here a cluster
of ``cluster_size`` blocks (1, 2, 4, 8 or 16) plays the mesh axis of the
reference, and rank r works on the r-th of ``cluster_size`` equal row
blocks of the leading dimension, as ``P(axis)`` splits it.  The kernels
are in ``kernels/dsm.py`` (``csrc/dsm.cu``); on CPU tensors each
function computes its plain version.

Three artifacts, mirroring the paper's three DSM benchmarks:
  * ring latency probe  -> one hop between neighbouring blocks
  * RBC ring-based copy -> every rank adds its buffer to rank (r+1)%CS,
    with ILP = number of independent chunks in flight
  * distributed histogram -> bins partitioned across the cluster vs.
    private per-block histograms
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dsm as _k
from repro_torch.models.common import resolve_device


def rbc_ring_copy(x: torch.Tensor, cluster_size: int, *, hops: int = 1,
                  ilp: int = 1) -> torch.Tensor:
    """Ring-Based Copy: each rank accumulates the buffer of rank-1 ... rank-hops.

    `ilp` splits the payload into independent in-flight chunks, the
    paper's instruction-level-parallelism knob in Fig. 8.  x is split
    over the cluster on its leading dim; the result has x's shape.
    """
    assert hops < cluster_size or cluster_size == 1
    return _k.rbc_ring_copy(x, cluster_size, hops=hops, ilp=ilp)


def ring_latency_probe(cluster_size: int, *, device=None) -> torch.Tensor:
    """One hop of a single word between neighbouring blocks — the
    SM-to-SM latency probe.  [CS, 1] int32, rank r holding r - 1."""
    x = torch.arange(cluster_size, dtype=torch.int32,
                     device=resolve_device(device)).reshape(cluster_size, 1)
    return _k.ring_latency_probe(x)


def histogram_private_psum(values: torch.Tensor, nbins: int,
                           cluster_size: int) -> torch.Tensor:
    """Baseline: a full private histogram per block, then summed.

    Every block counts all `nbins` bins over its share of the values.
    Shared memory per block: O(nbins).
    """
    return _k.histogram_private(values, nbins, cluster_size)


def histogram_dsm(values: torch.Tensor, nbins: int,
                  cluster_size: int) -> torch.Tensor:
    """DSM histogram: bins partitioned across the cluster.

    Each block owns `nbins/CS` bins, and every count is routed to the
    owner's shared memory by a DSM atomic.  Shared memory per block:
    O(nbins/CS), which is what lets Fig. 9's larger Nbins keep high
    occupancy.  Returns the whole [nbins] histogram.
    """
    assert nbins % cluster_size == 0, \
        "bins must split evenly across the cluster"
    return _k.histogram_dsm(values, nbins, cluster_size)


def all_to_all_exchange(x: torch.Tensor, cluster_size: int) -> torch.Tensor:
    """Full-cluster exchange (DSM load from every peer): rank r's shard,
    cut in `cluster_size` pieces, receives piece r of every rank."""
    return _k.all_to_all_exchange(x, cluster_size)


def modeled_rbc_throughput(payload_bytes: int, cluster_size: int, ilp: int,
                           link_gbps: float = 50.0) -> float:
    """Modeled RBC GB/s per core on the reference's v5e ICI ring.

    One hop moves the payload over one link; ILP pipelines chunks so the
    link stays busy; contention: all CS ranks share the ring's 2 links
    per hop direction -> per-core sustained bandwidth saturates at the
    link rate and *degrades* as rings lengthen (more hops in flight),
    mirroring the paper's 3.27 TB/s (CS=2) -> 2.65 TB/s (CS=4) drop.
    """
    startup_frac = 1.0 / (1.0 + ilp)          # un-overlapped first chunk
    contention = 2.0 / cluster_size if cluster_size > 2 else 1.0
    eff = (1.0 - startup_frac * 0.5) * min(1.0, contention + 0.5)
    return link_gbps * eff
