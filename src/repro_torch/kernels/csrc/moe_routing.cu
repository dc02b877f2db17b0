// MoE routing for Hopper (sm_90a): each (token, slot)'s position in its
// expert's buffer, and the per-expert counts, for G groups at once.
//
// It replaces the Pallas `moe_routing` of kernels/moe_routing.py in the
// JAX package (body `_routing_kernel`).  Input: (G, T, K) int32 expert
// ids; output: positions (G, T, K) int32, the exclusive count of earlier
// same-expert entries of the group in row-major (token, slot) order, and
// counts (G, E) int32.
//
// The TPU kernel walks token blocks in its sequential grid with a
// per-expert carry in VMEM and a one-hot cumsum inside the block.  Here
// one block owns one group and walks its T·K entries in tiles of
// blockDim entries, one entry per thread:
//   * inside a warp, __match_any_sync on the expert id gives each entry
//     its peers; its rank among them is popc(peers & lanemask_lt), and
//     the lowest peer writes the warp's count popc(peers) into a shared
//     (warps × E) table;
//   * threads e < E scan the table over warps per expert, adding the
//     running per-expert carry, and advance the carry;
//   * each entry's position is its warp's offset plus its rank.
// No atomic decides an order, so the result is deterministic and equal
// to the oracle's.  An id outside [0, E) is not counted; its position
// is written as 0 and nothing is read or written out of bounds for it.
//
// Bound: bytes, 2·G·T·K·4 + G·E·4.  One block per group keeps the order
// without a second pass; with few groups most SMs idle, and the tiles'
// barriers set the time.  A block histogram → scan over blocks → rank
// pass would spread one group over many SMs (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
enum { ERR_TOO_MANY_EXPERTS = 10003 };

__global__ void __launch_bounds__(kThreads)
routing_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ pos,
               int32_t* __restrict__ counts, long long n, int E) {
  extern __shared__ int32_t smem[];
  int32_t* table = smem;               // (kWarps, E): counts, then offsets
  int32_t* carry = smem + kWarps * E;  // (E): entries of earlier tiles
  const long long g = blockIdx.x;
  const int32_t* gid = ids + g * n;
  int32_t* gpos = pos + g * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  for (int e = threadIdx.x; e < E; e += kThreads) carry[e] = 0;
  for (long long base = 0; base < n; base += kThreads) {
    for (int i = threadIdx.x; i < kWarps * E; i += kThreads) table[i] = 0;
    __syncthreads();
    const long long idx = base + threadIdx.x;
    int e = -1;
    if (idx < n) {
      e = gid[idx];
      if (e < 0 || e >= E) e = -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & lt);
    if (e >= 0 && rank == 0) table[warp * E + e] = __popc(peers);
    __syncthreads();
    for (int x = threadIdx.x; x < E; x += kThreads) {
      int32_t run = carry[x];
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = table[w * E + x];
        table[w * E + x] = run;
        run += c;
      }
      carry[x] = run;
    }
    __syncthreads();
    if (idx < n) gpos[idx] = e >= 0 ? table[warp * E + e] + rank : 0;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += kThreads) counts[g * E + e] = carry[e];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// ERR_TOO_MANY_EXPERTS without launching when the (warps + 1) × E table
// does not fit a block's shared memory.
int mr_routing(const int32_t* ids, int32_t* pos, int32_t* counts,
               long long G, long long T, long long K, int E, void* stream) {
  if (G <= 0 || E <= 0) return 0;
  const size_t shmem = (size_t)(kWarps + 1) * E * sizeof(int32_t);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (shmem > (size_t)limit) return ERR_TOO_MANY_EXPERTS;
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        routing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  routing_kernel<<<(unsigned)G, kThreads, shmem, (cudaStream_t)stream>>>(
      ids, pos, counts, T * K, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
