// MoE routing for Hopper (sm_90a): each (token, slot)'s position in its
// expert's buffer, and the per-expert counts, for G groups at once.
//
// It replaces the Pallas `moe_routing` of kernels/moe_routing.py in the
// JAX package (body `_routing_kernel`).  Input: (G, T, K) int32 expert
// ids; output: positions (G, T, K) int32, the exclusive count of earlier
// same-expert entries of the group in row-major (token, slot) order, and
// counts (G, E) int32.  An id outside [0, E) is not counted and gets
// position 0.
//
// The TPU kernel walks token blocks in its sequential grid with a
// per-expert carry in VMEM.  Here one thread-block cluster of CL blocks
// owns one group (one launch, grid G·CL, CL in {1, 2, 4, 8}; the
// caller picks it, moe_routing.routing_cluster).  Block r of the cluster
// owns the contiguous chunk r of the group's n = T·K entries (chunk
// bounds are multiples of 4 entries; a chunk may be empty) and walks it
// in rounds of kThreads·kS entries, kS = kSteps or, for a short chunk,
// the least power of two that holds it (a template: every round is
// straight code).  In a round each warp takes a contiguous stretch, 32
// entries a step, lane order entry order:
//   * count: an entry's peers (same expert) come from one ballot per bit
//     of the id; its rank in the warp is popc(peers & lanes below) plus
//     the warp's running bin for the expert, which the lowest peer
//     advances.  An exclusive scan over the warps per expert (shuffles in
//     segments of kWarps lanes over the (expert, warp) table) turns the
//     bins into each warp's offset on top of the block's carry.
//   * write: position = offset + rank, straight from registers.
// With a cluster, the first round is counted before the exchange: its
// counts plus a histogram of the rest of the chunk (shared atomics,
// 16-byte loads where the base is aligned; empty when one round holds
// the chunk) are the block's histogram.  After cluster.sync() block r
// sums the histograms of ranks < r, read in their owners' shared memory
// through distributed shared memory (cluster.map_shared_rank): its
// per-expert base, added to the first round's offsets and to the carry.
// The last block writes the group's counts, its carry after its chunk.
// Nothing but the outputs is allocated and nothing outlives the launch:
// no global scratch, no flag a block waits on.  The hardware runs a
// cluster's blocks together, so the exchange needs only the cluster
// barrier; a block leaves only after every peer has read its histogram
// (the barrier's arrive after the exchange, its wait at the end).  With
// CL = 1 a cluster-free instantiation skips the exchange.  No atomic
// decides an order, so the result is deterministic and equal to the
// oracle's.
//
// Limits: shared memory is (kWarps·(E|1) + 2E) int32, so E ≤ 5810 on an
// H100 (227 KB a block); beyond that mr_prepare returns
// ERR_TOO_MANY_EXPERTS.  For a cluster size the card cannot schedule it
// returns ERR_CLUSTER_UNSCHEDULABLE (cudaOccupancyMaxActiveClusters);
// there is no fallback.  mr_prepare runs once per (card, E, CL), so a
// launch costs one cudaLaunchKernelEx.
//
// Bound: bytes, 2·G·T·K·4 + G·E·4 (each id read once, each output written
// once).  A chunk longer than one round reads its later ids twice, the
// second time mostly from L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;      // warp steps of 32 entries in a full round
constexpr int kMinBlocks = 4;  // resident blocks an SM must hold (64 registers)
constexpr int kLoads = 4;      // 16-byte loads in flight per thread
constexpr int kMaxBits = 13;   // ids in [0, E], E < 2^13
enum {
  ERR_TOO_MANY_EXPERTS = 10003,
  ERR_BAD_CLUSTER = 10004,
  ERR_CLUSTER_UNSCHEDULABLE = 10005,
};

// Row pitch of the (warp, expert) bins: odd, so the scan's column reads
// spread over the banks.
__host__ __device__ constexpr int pitch(int E) { return E | 1; }

size_t smem_bytes(int E, bool cluster) {
  return (size_t)(kWarps * pitch(E) + (cluster ? 2 : 1) * E) *
         sizeof(int32_t);
}

// The lanes whose x equals this lane's (x < 2^kBits): one ballot per bit,
// the bits where a lane differs or-ed together.  Every lane of the warp
// takes part.
template <int kBits>
__device__ __forceinline__ unsigned peers_of(int x) {
  unsigned differ = 0;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const unsigned bit = (x >> b) & 1u;
    differ |= __ballot_sync(0xffffffffu, bit) ^ (0u - bit);
  }
  return ~differ;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The steps of a chunk's rounds: kSteps, or for a short chunk the least
// power of two that still gives every warp its stretch in one round.
static_assert(kSteps == 8, "round_steps and the kernel's switch over it "
                           "know the step counts 1, 2, 4 and 8");
__device__ __forceinline__ int round_steps(long long len) {
  const long long q = (len + 32 * kWarps - 1) / (32 * kWarps);
  return q > kSteps / 2 ? kSteps : q > 2 ? 4 : q > 1 ? 2 : 1;
}

// Count the round of kS steps at b (b < hi): x gets each step's expert
// (E where not counted), r its rank among the warp's entries of that
// expert, and the bins the warp's offsets on top of carry, which
// advances past the round.  The steps are straight code (loads clamped
// into the chunk, no branches), so their ballots interleave.
template <int kBits, int kS>
__device__ __forceinline__ void count_round(
    const int32_t* __restrict__ gid, long long b, long long hi, int E,
    int32_t* bins, int32_t* carry, int (&x)[kS], int (&r)[kS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int P = pitch(E);
  int32_t* mine = bins + warp * P;  // this warp's running bins
  const long long at = b + 32LL * kS * warp + lane;
  unsigned peers[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) x[s] = gid[min(at + 32 * s, hi - 1)];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const bool in = at + 32 * s < hi && x[s] >= 0 && x[s] < E;
    x[s] = in ? x[s] : E;
    peers[s] = peers_of<kBits>(x[s]);
  }
  // the only chain: each step reads the bins the step before advanced
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const unsigned below = peers[s] & lt;
    const int run = x[s] < E ? mine[x[s]] : 0;
    r[s] = run + __popc(below);
    __syncwarp();
    if (x[s] < E && below == 0) mine[x[s]] = run + __popc(peers[s]);
    __syncwarp();
  }
  __syncthreads();
  // exclusive scan over the warps, per expert: element i is (expert
  // i / kWarps, warp i % kWarps), one segment of kWarps lanes each
  for (int base = 0; base < E * kWarps; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool ok = i < E * kWarps;
    const int e = i / kWarps, w = i % kWarps;
    const int c = ok ? bins[w * P + e] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d, kWarps);
      if (w >= d) incl += t;
    }
    int before = 0;
    if (ok) {
      before = carry[e];
      bins[w * P + e] = before + incl - c;
    }
    __syncwarp();
    if (ok && w == kWarps - 1) carry[e] = before + incl;
  }
  __syncthreads();
}

// Write the round at b that count_round counted; zero the warp's bins
// where another round follows.
template <int kS>
__device__ __forceinline__ void write_round(
    int32_t* __restrict__ gpos, long long b, long long hi, int E,
    int32_t* bins, const int (&x)[kS], const int (&r)[kS], bool more) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* mine = bins + warp * pitch(E);
  const long long at = b + 32LL * kS * warp + lane;
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (at + 32 * s < hi) gpos[at + 32 * s] = x[s] < E ? mine[x[s]] + r[s] : 0;
  if (more) {
    __syncwarp();
    for (int e = lane; e < E; e += 32) mine[e] = 0;
    __syncwarp();
  }
}

// The experts of [lo, hi) added into hist (shared atomics: counts decide
// no order).  lo is a multiple of 4, so where gid is 16-byte aligned
// every full quad is one load.
__device__ void histogram(const int32_t* __restrict__ gid, long long lo,
                          long long hi, int E, int32_t* hist) {
  const bool vec = (reinterpret_cast<uintptr_t>(gid) & 15) == 0;
  constexpr long long kSpan = 4LL * kThreads * kLoads;
  for (long long b = lo; b < hi; b += kSpan) {
    int x[4 * kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = b + 4LL * (threadIdx.x + u * kThreads);
      if (vec && i + 3 < hi) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(gid + i));
        x[4 * u] = q.x;
        x[4 * u + 1] = q.y;
        x[4 * u + 2] = q.z;
        x[4 * u + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[4 * u + j] = i + j < hi ? gid[i + j] : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < 4 * kLoads; ++j)
      if (x[j] >= 0 && x[j] < E) atomicAdd(&hist[x[j]], 1);
  }
}

// Block `rank` of the cluster ranks its chunk [lo, hi) of the group in
// rounds of kS steps.  With a cluster the first round is counted before
// the exchange and written after it.
template <bool kCluster, int kBits, int kS>
__device__ __forceinline__ void rank_chunk(
    const int32_t* __restrict__ gid, int32_t* __restrict__ gpos,
    long long lo, long long hi, int E, int cl, unsigned rank, int32_t* bins,
    int32_t* carry, int32_t* hist) {
  constexpr long long kSpan = 32LL * kWarps * kS;
  int x[kS], r[kS];
  if (lo < hi) count_round<kBits, kS>(gid, lo, hi, E, bins, carry, x, r);
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    histogram(gid, lo + kSpan, hi, E, hist);
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) hist[e] += carry[e];
    cluster.sync();  // every histogram of the cluster complete and visible
    const int P = pitch(E);
    for (int e = threadIdx.x; e < E; e += kThreads) {
      // four ranks' counts read at once (no load waits on a branch), the
      // ranks below this one summed
      int base = 0;
      for (int j0 = 0; j0 < (int)rank; j0 += 4) {
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = cluster.map_shared_rank(hist, j0 + j < cl ? j0 + j : 0)[e];
#pragma unroll
        for (int j = 0; j < 4; ++j) base += j0 + j < (int)rank ? v[j] : 0;
      }
      carry[e] += base;
      for (int w = 0; w < kWarps; ++w) bins[w * P + e] += base;
    }
    cluster_arrive();  // this block reads no peer's histogram any more
    __syncthreads();
  }
  if (lo < hi) write_round<kS>(gpos, lo, hi, E, bins, x, r, lo + kSpan < hi);
  for (long long b = lo + kSpan; b < hi; b += kSpan) {
    count_round<kBits, kS>(gid, b, hi, E, bins, carry, x, r);
    write_round<kS>(gpos, b, hi, E, bins, x, r, b + kSpan < hi);
  }
}

template <bool kCluster, int kBits>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
routing_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ pos,
               int32_t* __restrict__ counts, long long n, int E, int cl,
               long long chunk) {
  extern __shared__ int32_t smem[];
  const int P = pitch(E);
  int32_t* bins = smem;                // (kWarps, P)
  int32_t* carry = bins + kWarps * P;  // (E)
  int32_t* hist = carry + E;           // (E), with a cluster only
  unsigned rank = 0;
  if constexpr (kCluster) rank = cg::this_cluster().block_rank();
  const long long g = blockIdx.x / cl;
  const int32_t* gid = ids + g * n;
  int32_t* gpos = pos + g * n;
  const long long lo = min(n, (long long)rank * chunk);
  const long long hi = min(n, lo + chunk);
  const int zeros = kWarps * P + (kCluster ? 2 : 1) * E;
  for (int i = threadIdx.x; i < zeros; i += kThreads) smem[i] = 0;
  __syncthreads();
  switch (round_steps(hi - lo)) {
    case 1:
      rank_chunk<kCluster, kBits, 1>(gid, gpos, lo, hi, E, cl, rank, bins,
                                     carry, hist);
      break;
    case 2:
      rank_chunk<kCluster, kBits, 2>(gid, gpos, lo, hi, E, cl, rank, bins,
                                     carry, hist);
      break;
    case 4:
      rank_chunk<kCluster, kBits, 4>(gid, gpos, lo, hi, E, cl, rank, bins,
                                     carry, hist);
      break;
    default:
      rank_chunk<kCluster, kBits, kSteps>(gid, gpos, lo, hi, E, cl, rank,
                                          bins, carry, hist);
  }
  if (rank == (unsigned)cl - 1)
    for (int e = threadIdx.x; e < E; e += kThreads) counts[g * E + e] = carry[e];
  if constexpr (kCluster) cluster_wait();  // every peer done reading hist
}

using Kernel = void (*)(const int32_t*, int32_t*, int32_t*, long long, int,
                        int, long long);

template <int kBits>
Kernel kernel_for(int cl) {
  return cl == 1 ? routing_kernel<false, kBits> : routing_kernel<true, kBits>;
}

// One launch of G clusters of cl blocks (a plain launch for cl = 1); attr
// holds the cluster dimension the config points to.
cudaLaunchConfig_t config(long long G, int cl, size_t shmem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(G * cl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  return cfg;
}

// Allow the instance the card's whole shared memory where its tables
// pass the default 48 KB (one value, so no E undoes another's setting),
// and check that a cluster of cl such blocks can be scheduled.
template <int kBits>
int prepare(int cl, size_t shmem, int limit) {
  const Kernel kernel = kernel_for<kBits>(cl);
  if (shmem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        limit);
    if (err) return err;
  }
  if (cl == 1) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, cl, shmem, 0, &attr);
  int active = 0;
  const int err = (int)cudaOccupancyMaxActiveClusters(
      &active, (const void*)kernel, &cfg);
  if (err) return err;
  return active < 1 ? ERR_CLUSTER_UNSCHEDULABLE : 0;
}

template <int kBits>
int launch(const int32_t* ids, int32_t* pos, int32_t* counts, long long G,
           long long n, int E, int cl, size_t shmem, cudaStream_t s) {
  const long long chunk = ((n + cl - 1) / cl + 3) / 4 * 4;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(G, cl, shmem, s, &attr);
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel_for<kBits>(cl), ids,
                                          pos, counts, n, E, cl, chunk);
  if (err) return err;
  return (int)cudaGetLastError();
}

bool bad_cluster(int cl) { return cl != 1 && cl != 2 && cl != 4 && cl != 8; }

// The id bits the instance for E experts compares (ids in [0, E]).
int id_bits(int E) { return 32 - __builtin_clz((unsigned)E); }

}  // namespace

extern "C" {

// Sets the current card up for launches at E experts and cluster size cl:
// once per (card, E, cl), before the first (the wrapper caches it).
// Returns 0, ERR_BAD_CLUSTER (cl not in {1, 2, 4, 8}),
// ERR_TOO_MANY_EXPERTS (the shared tables do not fit a block),
// ERR_CLUSTER_UNSCHEDULABLE (cudaOccupancyMaxActiveClusters finds no
// place for a cluster), or a CUDA error.
int mr_prepare(int E, int cl) {
  if (bad_cluster(cl)) return ERR_BAD_CLUSTER;
  if (E <= 0) return 0;
  const size_t shmem = smem_bytes(E, cl > 1);
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (shmem > (size_t)limit || E >= (1 << kMaxBits))
    return ERR_TOO_MANY_EXPERTS;
  const int bits = id_bits(E);
  if (bits <= 7) return prepare<7>(cl, shmem, limit);
  if (bits <= 10) return prepare<10>(cl, shmem, limit);
  return prepare<kMaxBits>(cl, shmem, limit);
}

// One launch of G clusters of cl blocks on a card mr_prepare set up for
// (E, cl).  Returns cudaGetLastError() after the launch (0 on success),
// or without launching ERR_BAD_CLUSTER or ERR_TOO_MANY_EXPERTS.
int mr_routing(const int32_t* ids, int32_t* pos, int32_t* counts,
               long long G, long long T, long long K, int E, int cl,
               void* stream) {
  if (bad_cluster(cl)) return ERR_BAD_CLUSTER;
  if (G <= 0 || E <= 0) return 0;
  if (E >= (1 << kMaxBits)) return ERR_TOO_MANY_EXPERTS;
  const size_t shmem = smem_bytes(E, cl > 1);
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = T * K;
  const int bits = id_bits(E);
  if (bits <= 7) return launch<7>(ids, pos, counts, G, n, E, cl, shmem, s);
  if (bits <= 10) return launch<10>(ids, pos, counts, G, n, E, cl, shmem, s);
  return launch<kMaxBits>(ids, pos, counts, G, n, E, cl, shmem, s);
}

}  // extern "C"
