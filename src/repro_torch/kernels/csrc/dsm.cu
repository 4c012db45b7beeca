// Distributed shared memory for Hopper (sm_90a): thread-block-cluster
// kernels in place of the mesh-axis collectives of src/repro/core/dsm.py
// (shard_map + ppermute / psum / psum_scatter / all_to_all over ICI,
// paper §III-D-3, Figs. 8/9).  A cluster of CS blocks plays the mesh
// axis: block rank r of a cluster works on the r-th of CS equal row
// blocks of the input (the shard P(axis) gives rank r), and reaches
// its peers' shared memory through
// cooperative_groups::this_cluster().map_shared_rank.  Many clusters
// run side by side, each on a tile of the shards, so the card is full.
//
// rbc_ring_copy_fwd: rank r accumulates ranks r-1, ..., r-hops (adding
//   in that order, as the reference does), float32 or int32 (wrapping
//   adds).  A block holds a column tile of its rank's shard; the chunk
//   that moves round the ring is double buffered in shared memory, one
//   cluster.sync() per hop; each thread keeps `ilp` (1, 2, 4 or 8)
//   independent chunks (and `ilp` remote loads) in flight.  A cluster
//   of one block is its own ring: it adds `hops` copies of its chunk.
// ring_latency_probe_fwd: one cluster; rank r reads rank r-1's word.
// histogram_fwd: `dsm`=0: each block counts into a whole private
//   histogram in its shared memory; `dsm`=1: each block owns nbins/CS
//   bins and every count is an atomicAdd into the owner's bins.  Both
//   flush their bins with atomicAdd into the zeroed global output.
// all_to_all_fwd: rank r's output piece i is piece r of rank i's shard,
//   read from peer i's shared memory.
//
// A block whose shared memory its peers read must not exit before they
// are done: every kernel ends its peer reads with a cluster.sync().
//
// Cluster sizes 1, 2, 4, 8 and 16.  A cluster of 1 is the no-DSM case
// (map_shared_rank(p, 0) is the block's own shared memory).  16 is past
// the portable 8 and needs cudaFuncAttributeNonPortableClusterSizeAllowed;
// before such a launch cudaOccupancyMaxActiveClusters is asked whether a
// cluster of 16 blocks with the kernel's shared memory fits the card, and
// where none fits the launch is refused (cudaErrorInvalidConfiguration,
// which the wrappers turn into a ValueError).
//
// What bounds them: device-memory bytes (each input read once, each
// output written once); the peer traffic stays on the SM-to-SM network.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;
constexpr int kMaxBlocks = 132 * 8;       // blocks a launch aims at

constexpr int kPortableCluster = 8;

bool valid_cluster(int cs) {
  return cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16;
}

// Set what a launch of `kernel` with `smem` bytes in clusters of `cs`
// needs: the dynamic shared memory past 48 KiB, the non-portable size.
template <class... Params>
cudaError_t allow(void (*kernel)(Params...), int cs, int smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (cs > kPortableCluster)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(long long blocks, int cs, int threads,
                                  int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` on `clusters` clusters of `cs` blocks each; a cluster
// of 16 only where the card holds one.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), long long clusters,
                           int cs, int threads, int smem,
                           cudaStream_t stream, Args... args) {
  if (clusters < 1 || clusters * cs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = allow(kernel, cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  if (cs > kPortableCluster) {
    int n = 0;
    cudaLaunchConfig_t one = cluster_config(cs, cs, threads, smem, stream,
                                            attr);
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &one);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
  }
  cudaLaunchConfig_t cfg = cluster_config(clusters * cs, cs, threads, smem,
                                          stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// ring-based copy
// ---------------------------------------------------------------------

template <typename T, int ILP>
__global__ void __launch_bounds__(kThreads)
    rbc_kernel(const T* __restrict__ x, T* __restrict__ out, long long L,
               int hops) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);   // [2][ILP * blockDim]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int prev = (rank + cs - 1) % cs;
  const int tile = ILP * blockDim.x;
  const long long base = static_cast<long long>(blockIdx.x / cs) * tile;
  const T* xs = x + static_cast<long long>(rank) * L;
  T acc[ILP];
#pragma unroll
  for (int k = 0; k < ILP; ++k) {
    const int slot = k * blockDim.x + threadIdx.x;
    const long long idx = base + slot;
    const T v = idx < L ? xs[idx] : T(0);
    acc[k] = v;
    buf[slot] = v;
  }
  for (int h = 1; h <= hops; ++h) {
    cluster.sync();                          // hop h-1's chunk is written
    const T* src = cluster.map_shared_rank(buf + ((h - 1) & 1) * tile, prev);
    T* dst = buf + (h & 1) * tile;
    T moved[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) moved[k] = src[k * blockDim.x + threadIdx.x];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      acc[k] = acc[k] + moved[k];
      dst[k * blockDim.x + threadIdx.x] = moved[k];
    }
  }
  cluster.sync();                            // peers are done reading
#pragma unroll
  for (int k = 0; k < ILP; ++k) {
    const long long idx = base + k * blockDim.x + threadIdx.x;
    if (idx < L) out[static_cast<long long>(rank) * L + idx] = acc[k];
  }
}


// ---------------------------------------------------------------------
// latency probe
// ---------------------------------------------------------------------

__global__ void probe_kernel(const int* __restrict__ x,
                             int* __restrict__ out) {
  __shared__ int word;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x == 0) word = x[rank];
  cluster.sync();
  if (threadIdx.x == 0)
    out[rank] = *cluster.map_shared_rank(&word, (rank + cs - 1) % cs);
  cluster.sync();                            // the peer has read `word`
}

// ---------------------------------------------------------------------
// histograms
// ---------------------------------------------------------------------

int hist_smem(int dsm, int nbins, int cs) {
  return 4 * (dsm ? nbins / cs : nbins);
}

template <bool kDsm>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ values, int* __restrict__ out,
                long long shard_len, int nbins) {
  extern __shared__ int hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int own = kDsm ? nbins / cs : nbins;   // bins this block holds
  for (int t = threadIdx.x; t < own; t += blockDim.x) hist[t] = 0;
  if (kDsm) cluster.sync();                  // every owner's bins are 0
  else __syncthreads();
  const int* vs = values + static_cast<long long>(rank) * shard_len;
  const long long g = blockIdx.x / cs, groups = gridDim.x / cs;
  for (long long i = g * blockDim.x + threadIdx.x; i < shard_len;
       i += groups * blockDim.x) {
    const int v = vs[i];
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(nbins)) continue;
    if (kDsm) {
      const int owner = v / own;
      atomicAdd(cluster.map_shared_rank(hist, owner) + (v - owner * own), 1);
    } else {
      atomicAdd(hist + v, 1);
    }
  }
  if (kDsm) cluster.sync();                  // all counts are in; peers done
  else __syncthreads();
  const int off = kDsm ? rank * own : 0;
  for (int t = threadIdx.x; t < own; t += blockDim.x) {
    const int c = hist[t];
    if (c) atomicAdd(out + off + t, c);
  }
}

// ---------------------------------------------------------------------
// all-to-all
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    a2a_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
               long long P) {
  extern __shared__ unsigned pieces[];       // [cs][blockDim]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long p =
      static_cast<long long>(blockIdx.x / cs) * blockDim.x + threadIdx.x;
  const unsigned* xs = x + static_cast<long long>(rank) * cs * P;
  for (int j = 0; j < cs; ++j)
    pieces[j * blockDim.x + threadIdx.x] = p < P ? xs[j * P + p] : 0u;
  cluster.sync();                            // every rank's pieces staged
  unsigned* os = out + static_cast<long long>(rank) * cs * P;
  for (int i = 0; i < cs; ++i) {
    const unsigned v =
        cluster.map_shared_rank(pieces, i)[rank * blockDim.x + threadIdx.x];
    if (p < P) os[i * P + p] = v;
  }
  cluster.sync();                            // peers are done reading
}

template <typename T>
cudaError_t rbc_dispatch(const void* x, void* out, int cs, long long L,
                         int hops, int ilp, long long clusters,
                         cudaStream_t s) {
  const T* px = static_cast<const T*>(x);
  T* po = static_cast<T*>(out);
  const int smem = 2 * ilp * kThreads * static_cast<int>(sizeof(T));
  switch (ilp) {
    case 1: return launch_cluster(rbc_kernel<T, 1>, clusters, cs, kThreads,
                                  smem, s, px, po, L, hops);
    case 2: return launch_cluster(rbc_kernel<T, 2>, clusters, cs, kThreads,
                                  smem, s, px, po, L, hops);
    case 4: return launch_cluster(rbc_kernel<T, 4>, clusters, cs, kThreads,
                                  smem, s, px, po, L, hops);
    case 8: return launch_cluster(rbc_kernel<T, 8>, clusters, cs, kThreads,
                                  smem, s, px, po, L, hops);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x and out [cs, L] (rank r's shard is row r), float32 (dtype 0) or
// int32 (dtype 1); hops < cs, or any hops >= 0 for a cluster of one.
int rbc_ring_copy_fwd(int dtype, const void* x, void* out, int cs,
                      long long L, int hops, int ilp, void* stream) {
  if (!valid_cluster(cs) || L <= 0 || hops < 0 || (hops >= cs && cs > 1) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long clusters = (L + ilp * kThreads - 1) / (ilp * kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return rbc_dispatch<int>(x, out, cs, L, hops, ilp, clusters, s);
  return rbc_dispatch<float>(x, out, cs, L, hops, ilp, clusters, s);
}

// int32 x [cs] -> out [cs], out[r] = x[(r - 1) mod cs].
int ring_latency_probe_fwd(const void* x, void* out, int cs, void* stream) {
  if (!valid_cluster(cs)) return cudaErrorInvalidValue;
  return launch_cluster(probe_kernel, 1, cs, 32, 0,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const int*>(x), static_cast<int*>(out));
}

// Bytes of dynamic shared memory one histogram block uses.
int histogram_smem_bytes(int dsm, int nbins, int cs) {
  return hist_smem(dsm, nbins, cs);
}

// int32 values [cs, shard_len] -> counts added into int32 out [nbins]
// (zeroed by the caller); values outside [0, nbins) are not counted.
int histogram_fwd(int dsm, const void* values, void* out,
                  long long shard_len, int nbins, int cs, void* stream) {
  if (!valid_cluster(cs) || shard_len <= 0 || nbins <= 0 ||
      (dsm && nbins % cs))
    return cudaErrorInvalidValue;
  long long clusters = (shard_len + 16LL * kThreads - 1) / (16LL * kThreads);
  const long long most = kMaxBlocks / cs;
  if (clusters > most) clusters = most;
  const int smem = hist_smem(dsm, nbins, cs);
  auto s = static_cast<cudaStream_t>(stream);
  const int* pv = static_cast<const int*>(values);
  int* po = static_cast<int*>(out);
  if (dsm)
    return launch_cluster(hist_kernel<true>, clusters, cs, kThreads, smem, s,
                          pv, po, shard_len, nbins);
  return launch_cluster(hist_kernel<false>, clusters, cs, kThreads, smem, s,
                        pv, po, shard_len, nbins);
}

// 32-bit elements; x and out [cs, cs, P]: out[r, i] = x[i, r].
int all_to_all_fwd(const void* x, void* out, int cs, long long P,
                   void* stream) {
  if (!valid_cluster(cs) || P <= 0) return cudaErrorInvalidValue;
  const long long clusters = (P + kThreads - 1) / kThreads;
  return launch_cluster(a2a_kernel, clusters, cs, kThreads,
                        4 * cs * kThreads, static_cast<cudaStream_t>(stream),
                        static_cast<const unsigned*>(x),
                        static_cast<unsigned*>(out), P);
}

}  // extern "C"
