"""Thread-block-cluster kernels: wrappers of csrc/dsm.cu.

The kernels behind ``core/dsm.py`` (paper §III-D-3, Figs. 8/9).  A
cluster of ``cluster_size`` blocks (1, 2, 4, 8 or 16) plays the
reference's mesh axis, and rank r of a cluster works on the r-th of
``cluster_size`` equal row blocks of the input's leading dimension, the
shard ``P(axis)`` gives rank r.  Peers' shared memory is read through
``cooperative_groups::this_cluster().map_shared_rank``.  A cluster of 1
is the no-DSM case (its own shared memory); 16 is past the portable
size, and where the card holds no cluster of 16 blocks with the
kernel's shared memory the source refuses the launch and the wrapper
raises ValueError.

  * rbc_ring_copy — rank r accumulates ranks r-1 ... r-hops, in that
    order (float32 results bitwise the reference's; int32 adds wrap);
    ``ilp`` (1, 2, 4 or 8) chunks in flight per thread.  A cluster of
    1 adds ``hops`` copies of its own chunk, as a one-rank ring does.
  * ring_latency_probe — one hop of one word per rank.
  * histogram_private / histogram_dsm — a whole private histogram per
    block in shared memory, or bins split over the cluster with every
    count an atomicAdd into the owning block's shared memory.
  * all_to_all_exchange — rank r's piece i is piece r of rank i.

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed
and adds one to its ``launches`` count.  For CPU tensors it computes the
plain version (``*_plain``).  It never falls back from CUDA to the plain
version.  Kernel and plain version agree exactly (integer counts, and
float32 sums taken in the same order).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

SOURCE = "dsm.cu"
CLUSTER_SIZES = (1, 2, 4, 8, 16)
PORTABLE_CLUSTER = 8
ILPS = (1, 2, 4, 8)
RING_DTYPES = (torch.float32, torch.int32)
# what the source returns where no cluster past the portable size fits
_NO_CLUSTER_FITS = 9                # cudaErrorInvalidConfiguration


def _check_cluster(fn_name: str, cluster_size: int) -> None:
    if cluster_size not in CLUSTER_SIZES:
        raise ValueError(f"{fn_name}: cluster_size={cluster_size} not one of "
                         f"{CLUSTER_SIZES}")


def _check_shards(fn_name: str, x: torch.Tensor, cluster_size: int) -> None:
    _check_cluster(fn_name, cluster_size)
    if x.ndim < 1 or x.shape[0] % cluster_size or x.numel() == 0:
        raise ValueError(f"{fn_name}: leading dim of {tuple(x.shape)} does "
                         f"not split into {cluster_size} equal row blocks")


def _cuda_operand(fn_name: str, x: torch.Tensor, dtypes) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{fn_name}: dtype {x.dtype}; the kernel takes "
                        f"{sorted(map(str, dtypes))}")
    if not x.is_contiguous():
        raise ValueError(f"{fn_name}: the operand must be contiguous")


def _launch(fn_name: str, entry: str, x: torch.Tensor, cluster_size: int,
            *args) -> None:
    """Launch `entry` on x's device; a cluster the card cannot hold is a
    ValueError."""
    try:
        build.launch(SOURCE, entry, x.device, *args)
    except build.LaunchError as e:
        if cluster_size > PORTABLE_CLUSTER and e.code == _NO_CLUSTER_FITS:
            raise ValueError(f"{fn_name}: no cluster of {cluster_size} "
                             "blocks with this kernel's shared memory fits "
                             "the card") from e
        raise


def histogram_smem_bytes(dsm: bool, nbins: int, cluster_size: int) -> int:
    """`histogram_smem_bytes` of the source: the bins one block holds."""
    return 4 * (nbins // cluster_size if dsm else nbins)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def rbc_ring_copy_plain(x: torch.Tensor, cluster_size: int, *,
                        hops: int = 1) -> torch.Tensor:
    xs = x.reshape(cluster_size, -1)
    acc, moved = xs, xs
    for _ in range(hops):
        moved = moved.roll(1, dims=0)        # rank r gets rank r-1's chunk
        acc = acc + moved
    return acc.reshape(x.shape)


def ring_latency_probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x.roll(1, dims=0)


def _local_counts(values: torch.Tensor, nbins: int,
                  cluster_size: int) -> torch.Tensor:
    """[cluster_size, nbins] int32 counts of each rank's shard; values
    outside [0, nbins) are not counted."""
    counts = []
    for shard in values.reshape(cluster_size, -1):
        shard = shard[(shard >= 0) & (shard < nbins)].long()
        counts.append(torch.bincount(shard, minlength=nbins))
    return torch.stack(counts).to(torch.int32)


def histogram_private_plain(values: torch.Tensor, nbins: int,
                            cluster_size: int) -> torch.Tensor:
    """Every rank counts all bins over its shard; the counts are summed."""
    return _local_counts(values, nbins, cluster_size).sum(
        0, dtype=torch.int32)


def histogram_dsm_plain(values: torch.Tensor, nbins: int,
                        cluster_size: int) -> torch.Tensor:
    """Rank r keeps the sum over ranks of its nbins/CS bins; the ranks'
    bins concatenated."""
    local = _local_counts(values, nbins, cluster_size)
    own = nbins // cluster_size
    return torch.cat([local[:, r * own:(r + 1) * own].sum(0, dtype=torch.int32)
                      for r in range(cluster_size)])


def all_to_all_exchange_plain(x: torch.Tensor,
                              cluster_size: int) -> torch.Tensor:
    cs = cluster_size
    return x.reshape(cs, cs, -1).transpose(0, 1).reshape(x.shape)


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------

def rbc_ring_copy(x: torch.Tensor, cluster_size: int, *, hops: int = 1,
                  ilp: int = 1) -> torch.Tensor:
    """Ring-based copy over a cluster: rank r's row block plus ranks
    r-1 ... r-hops' (float32 or int32).  hops < cluster_size, as the
    reference asserts, except on a one-block ring."""
    _check_shards("rbc_ring_copy", x, cluster_size)
    if hops < 0 or (hops >= cluster_size and cluster_size != 1):
        raise ValueError(f"rbc_ring_copy: hops={hops} needs 0 <= hops < "
                         f"cluster_size={cluster_size}")
    if ilp not in ILPS or x.shape[-1] % ilp:
        raise ValueError(f"rbc_ring_copy: ilp={ilp} must be one of {ILPS} "
                         f"and divide the last dim {x.shape[-1]}")
    if x.device.type == "cpu":
        return rbc_ring_copy_plain(x, cluster_size, hops=hops)
    _cuda_operand("rbc_ring_copy", x, RING_DTYPES)
    is_int = x.dtype == torch.int32
    out = torch.empty_like(x)
    _launch("rbc_ring_copy", "rbc_ring_copy_fwd", x, cluster_size,
            int(is_int), x.data_ptr(), out.data_ptr(), cluster_size,
            x.numel() // cluster_size, hops, ilp)
    rbc_ring_copy.launches += 1
    return out


def ring_latency_probe(x: torch.Tensor) -> torch.Tensor:
    """One hop of one int32 word per rank: x [CS, 1] -> x rolled by one
    rank; a cluster of CS = x.shape[0] blocks."""
    if x.ndim != 2 or x.shape[1] != 1:
        raise ValueError(f"ring_latency_probe: shape {tuple(x.shape)} is not "
                         "[cluster_size, 1]")
    _check_cluster("ring_latency_probe", x.shape[0])
    if x.device.type == "cpu":
        return ring_latency_probe_plain(x)
    _cuda_operand("ring_latency_probe", x, (torch.int32,))
    out = torch.empty_like(x)
    _launch("ring_latency_probe", "ring_latency_probe_fwd", x, x.shape[0],
            x.data_ptr(), out.data_ptr(), x.shape[0])
    ring_latency_probe.launches += 1
    return out


def _histogram(fn, dsm: bool, values: torch.Tensor, nbins: int,
               cluster_size: int) -> torch.Tensor:
    name = fn.__name__
    if values.ndim != 1:
        raise ValueError(f"{name}: values of shape {tuple(values.shape)}, "
                         "not 1-D")
    _check_shards(name, values, cluster_size)
    if nbins < 1 or (dsm and nbins % cluster_size):
        even = " and split evenly over the cluster" if dsm else ""
        raise ValueError(f"{name}: nbins={nbins} must be positive{even}")
    _mm.check_smem(name, histogram_smem_bytes(dsm, nbins, cluster_size),
                   f"({nbins} bins)")
    if values.device.type == "cpu":
        plain = histogram_dsm_plain if dsm else histogram_private_plain
        return plain(values, nbins, cluster_size)
    _cuda_operand(name, values, (torch.int32,))
    out = torch.zeros(nbins, dtype=torch.int32, device=values.device)
    _launch(name, "histogram_fwd", values, cluster_size, int(dsm),
            values.data_ptr(), out.data_ptr(),
            values.numel() // cluster_size, nbins, cluster_size)
    fn.launches += 1
    return out


def histogram_private(values: torch.Tensor, nbins: int,
                      cluster_size: int) -> torch.Tensor:
    """[nbins] int32 counts, a whole private histogram per block."""
    return _histogram(histogram_private, False, values, nbins, cluster_size)


def histogram_dsm(values: torch.Tensor, nbins: int,
                  cluster_size: int) -> torch.Tensor:
    """[nbins] int32 counts, the bins split over the cluster."""
    return _histogram(histogram_dsm, True, values, nbins, cluster_size)


def all_to_all_exchange(x: torch.Tensor, cluster_size: int) -> torch.Tensor:
    """Rank r's shard, cut in cluster_size pieces, becomes piece r of
    every rank's shard (32-bit elements)."""
    _check_shards("all_to_all_exchange", x, cluster_size)
    if x.numel() % (cluster_size * cluster_size):
        raise ValueError(f"all_to_all_exchange: a shard of {tuple(x.shape)} "
                         f"does not cut into {cluster_size} pieces")
    if x.device.type == "cpu":
        return all_to_all_exchange_plain(x, cluster_size)
    _cuda_operand("all_to_all_exchange", x, (torch.float32, torch.int32))
    out = torch.empty_like(x)
    _launch("all_to_all_exchange", "all_to_all_fwd", x, cluster_size,
            x.data_ptr(), out.data_ptr(), cluster_size,
            x.numel() // (cluster_size * cluster_size))
    all_to_all_exchange.launches += 1
    return out


KERNELS = (rbc_ring_copy, ring_latency_probe, histogram_private,
           histogram_dsm, all_to_all_exchange)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
