// The chunked-scan engine for Hopper (sm_90a): a single-pass scan along
// the row axis of (G, T, D) buffers.
//
// It replaces the Pallas `chunked_scan` of kernels/scan_engine.py in the
// JAX package (body `_scan_body`), and with it that kernel's three
// instances:
//
//   monoid_exscan         row t = x_0 ⊕ … ⊕ x_{t-1}, row 0 the identity,
//                         under an elementwise ⊕ (cs_monoid)
//   affine_chunk_scan     h_t = a_t·h_{t-1} + b_t from h0 (cs_affine)
//   affine_chunk_summary  (A_total, B_total) of the whole slice, from
//                         the identity (1, 0) (cs_affine)
//
// The TPU kernel walks 256-row chunks in its sequential grid with the
// carry in VMEM.  Blocks on this card run in no order, so nothing of
// that carries over.  cs_monoid runs one of two designs, both in one
// launch, chosen by the caller (scan_engine.monoid_chunk_regime):
//
// Regime A, an integer ⊕ (add, mul, max, min, xor at int32/int64) with
// D = 1: a single-pass scan with decoupled look-back (Merrill & Garland,
// 2016).  A tile is 256 threads × 16 elements, moved as 16-byte vectors
// in warp-striped rows (each warp load or store covers 512 contiguous
// bytes); a warp scans its rows with shuffles, carrying row to row, and
// the block scans its warp totals in shared memory.  The tile index comes
// from an atomic counter, so every predecessor has started (forward
// progress).  Each tile publishes its aggregate, then its inclusive
// prefix, as a flag and a value in a scratch the wrapper allocates (a
// fence between the value and its flag); one warp looks back over 32
// predecessors at a time until it meets an inclusive prefix.  These ⊕
// wrap exactly and associate bit for bit, so the result is
// bit-identical to a left fold and the same in every run, whatever
// order the look-back finds.  Groups (G > 1) scan apart: tiles run over
// (g, tile).  Bound: 2·G·T·itemsize bytes.
//
// Regime B, everything else (every float ⊕, every ⊕ at D ≥ 2): the left
// fold per column stays, so floats round exactly as a plain row loop
// does.  One block owns a strip of 256 bytes of columns of one group
// (64 fp32, 32 int64) and streams 64-row tiles of it through a 4-stage
// ring in shared memory, filled by cp.async (16 bytes per copy where
// rows are 16-byte aligned, else one element per copy): up to 48 KB in
// flight per block.  A consumer thread per column reads its column down
// each tile, conflict-free, folds in row order and writes the results
// into an output tile in shared memory, which every thread of the block
// then stores with 16-byte stores.  Bound: 2·G·T·D·itemsize bytes.  Weak spot: the blocks are the G·⌈D/C⌉ strips, so where G·D is
// small (a float ⊕ at small D, an integer ⊕ at a small D ≥ 2) few SMs
// work and each walks its whole column: slow, but in order and right.
// No path of the port runs that case.  T = 0 also takes this kernel,
// which then only writes the finals.
//
// cs_affine (the affine recurrence) keeps one thread per (g, column)
// walking T with the carry (A, h) in registers: consecutive threads
// take consecutive columns, so every row's loads and stores coalesce,
// and at its paths' shapes (G·D ≥ 2²¹) it runs at 83-86 % of its bound,
// 3·G·T·D·itemsize plus the h0 and final rows (the summary
// 2·G·T·D·itemsize + 2·G·D·itemsize).
//
// Rounding: the ⊕ of monoid_ops.cuh, as PyTorch's elementwise kernels
// round (bf16 rounds the carry after every step), so every kernel is
// bit-identical to its plain version.

#include <limits.h>
#include <string.h>

#include "monoid_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum { REGIME_LOOKBACK = 0, REGIME_STRIP = 1 };
enum { ERR_TOO_LARGE = 10003 };

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- regime A: decoupled look-back over 4096-element tiles ---------------

constexpr int kItems = 16;
constexpr long long kTile = (long long)kThreads * kItems;
enum { TILE_EMPTY = 0, TILE_AGGREGATE = 1, TILE_PREFIX = 2 };
constexpr unsigned kBackoffNs = 100;  // between two polls of a window

// L2-only loads and stores of the tile status (never a stale L1 line).
__device__ __forceinline__ void st_cg(int* p, int v) {
  asm volatile("st.global.cg.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cg(int64_t* p, int64_t v) {
  asm volatile("st.global.cg.s64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ int ld_cg(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int64_t ld_cg(const int64_t* p) {
  int64_t v;
  asm volatile("ld.global.cg.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <class T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  if (sizeof(T) == 8) return (T)__shfl_up_sync(kFull, (long long)v, d);
  return (T)__shfl_up_sync(kFull, (int)v, d);
}
template <class T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  if (sizeof(T) == 8) return (T)__shfl_sync(kFull, (long long)v, src);
  return (T)__shfl_sync(kFull, (int)v, src);
}
template <class T>
__device__ __forceinline__ T shfl_xor(T v, int d) {
  if (sizeof(T) == 8) return (T)__shfl_xor_sync(kFull, (long long)v, d);
  return (T)__shfl_xor_sync(kFull, (int)v, d);
}

// The value first, then (after a fence) the flag that announces it.
template <class T>
__device__ __forceinline__ void publish(int* flags, T* vals, long long i,
                                        int flag, T v) {
  st_cg(vals + i, v);
  __threadfence();
  st_cg(flags + i, flag);
}

// The scratch: an int tile counter (16 bytes), one int flag per tile,
// then the aggregates and the inclusive prefixes (8-byte slots).
long long round16(long long b) { return (b + 15) / 16 * 16; }
long long lookback_tiles(long long G, long long T) {
  return G * ((T + kTile - 1) / kTile);
}
long long lookback_scratch_bytes(long long tiles) {
  return 16 + round16(4 * tiles) + 16 * tiles;
}

template <class T, class F>
__global__ void __launch_bounds__(kThreads)
lookback_scan_kernel(const T* __restrict__ x, const T* __restrict__ init,
                     T* __restrict__ out, T* __restrict__ fin, T identity,
                     int exclusive, long long T_, long long tiles,
                     int* counter, int* flags, T* agg, T* incl) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kVec = 16 / sizeof(T);     // elements of one 16-byte vector
  constexpr int kRows = kItems / kVec;     // vectors per thread
  constexpr int kRowSpan = 32 * kVec;      // elements of one warp row
  __shared__ int s_id;
  __shared__ T s_warp[kWarps];
  __shared__ T s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_id = atomicAdd(counter, 1);
  __syncthreads();
  const long long id = s_id;
  const long long g = id / tiles;
  const long long tile = id - g * tiles;
  const long long t0 = tile * kTile;
  const bool vec = t0 + kTile <= T_ && aligned16(x + g * T_ + t0) &&
                   (out == nullptr || aligned16(out + g * T_ + t0));

  // Warp w owns the tile's elements [w·32·kItems, (w+1)·32·kItems), as
  // kRows warp rows of 32 vectors: lane l holds vector l of each row,
  // so every load and store of a warp covers 512 contiguous bytes.
  const T* xg = x + g * T_;
  const long long wbase = t0 + (long long)warp * 32 * kItems + lane * kVec;
  T v[kRows][kVec];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = wbase + (long long)k * kRowSpan;
    if (vec) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(xg + i));
      memcpy(v[k], &w, 16);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[k][e] = i + e < T_ ? xg[i + e] : identity;
    }
  }

  // The warp's scan, row by row: v becomes each element's prefix within
  // the warp's span (exclusive or inclusive), `carry` the span's total.
  T carry = identity;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    T local[kVec];  // exclusive prefixes within the lane's vector
    T sum = identity;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      local[e] = sum;
      sum = F::f(sum, v[k][e]);
    }
    T inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T o = shfl_up(inc, d);
      if (lane >= d) inc = F::f(o, inc);
    }
    T before = shfl_up(inc, 1);
    if (lane == 0) before = identity;
    const T base = F::f(carry, before);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[k][e] = F::f(base, exclusive ? local[e] : F::f(local[e], v[k][e]));
    carry = F::f(carry, shfl_idx(inc, 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  T ahead = identity;  // the spans of the warps before this one
  for (int w = 0; w < warp; ++w) ahead = F::f(ahead, s_warp[w]);

  if (warp == 0) {
    T total = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total = F::f(total, s_warp[w]);
    const long long base = g * tiles;  // status slot of the group's tile 0
    T prefix;
    if (tile == 0) {
      prefix = init == nullptr ? identity : init[g];
    } else {
      if (lane == 0) publish(flags, agg, base + tile, TILE_AGGREGATE, total);
      prefix = identity;
      for (long long hi = tile - 1;; hi -= 32) {
        const long long t = hi - lane;  // lane 0 is the nearest predecessor
        int f;
        while (true) {
          f = t >= 0 ? ld_cg(flags + base + t) : TILE_PREFIX;
          if (!__any_sync(kFull, f == TILE_EMPTY)) break;
          __nanosleep(kBackoffNs);  // spare the L2 lines being polled
        }
        __threadfence();
        T val = identity;
        if (t >= 0) val = ld_cg((f == TILE_PREFIX ? incl : agg) + base + t);
        const unsigned done = __ballot_sync(kFull, f == TILE_PREFIX);
        const int stop = done ? __ffs(done) - 1 : 31;  // nearest prefix
        if (lane > stop) val = identity;
#pragma unroll
        for (int d = 16; d; d >>= 1) val = F::f(val, shfl_xor(val, d));
        prefix = F::f(val, prefix);  // this window lies before the last
        if (done) break;
      }
    }
    if (lane == 0) {
      const T inclusive = F::f(prefix, total);
      if (tile + 1 < tiles)
        publish(flags, incl, base + tile, TILE_PREFIX, inclusive);
      else if (fin != nullptr)
        fin[g] = inclusive;
      s_prefix = prefix;
    }
  }
  __syncthreads();

  if (out == nullptr) return;
  const T head = F::f(s_prefix, ahead);
  T* og = out + g * T_;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = wbase + (long long)k * kRowSpan;
    T o[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = F::f(head, v[k][e]);
    if (vec) {
      uint4 w;
      memcpy(&w, o, 16);
      *reinterpret_cast<uint4*>(og + i) = w;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (i + e < T_) og[i + e] = o[e];
    }
  }
}

// ---- regime B: a strip of columns streamed through a shared-memory ring --

constexpr int kStripBytes = 256;   // a strip's share of one row
constexpr int kStageBytes = 16384;  // one tile: 64 rows of a strip
constexpr int kStages = 4;
constexpr int kRingBytes = (kStages + 1) * kStageBytes;  // + the output tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(s)),
               "l"(g)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_ca(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(s)),
               "l"(g), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One element into shared memory: cp.async moves 4, 8 or 16 bytes, so a
// 2-byte element takes a plain load (done before the next barrier).
template <class T>
__device__ __forceinline__ void copy_in(T* s, const T* g) {
  if constexpr (sizeof(T) >= 4) {
    cp_async_ca<sizeof(T)>(s, g);
  } else {
    *s = *g;
  }
}

template <class T, class F>
__global__ void __launch_bounds__(kThreads)
strip_scan_kernel(const T* __restrict__ x, const T* __restrict__ init,
                  T* __restrict__ out, T* __restrict__ fin, T identity,
                  int exclusive, long long T_, long long D, long long strips,
                  int vec) {
  constexpr int C = kStripBytes / sizeof(T);  // columns of a strip
  constexpr int R = kStageBytes / kStripBytes;  // rows of a tile
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  T* ring = reinterpret_cast<T*>(ring_bytes);  // kStages input tiles
  T* otile = ring + kStages * (R * C);         // then the output tile
  const long long g = blockIdx.x / strips;
  const long long c0 = (blockIdx.x - g * strips) * C;
  const T* xg = x + g * T_ * D;
  T* og = out == nullptr ? nullptr : out + g * T_ * D;
  const long long tiles = (T_ + R - 1) / R;

  // Tile k's rows between global memory and a shared tile, by every
  // thread: 16-byte copies where rows are 16-byte aligned (a copy is
  // then wholly in or out of range), else one element per copy.
  auto fill = [&](long long k) {
    T* s = ring + (k % kStages) * (R * C);
    const long long t0 = k * R;
    if (vec) {
      for (int e = threadIdx.x; e < R * (C / E); e += kThreads) {
        const int r = e / (C / E);
        const int j = (e - r * (C / E)) * E;
        const long long t = t0 + r, c = c0 + j;
        if (t < T_ && c < D) cp_async16(s + r * C + j, xg + t * D + c);
      }
    } else {
      for (int e = threadIdx.x; e < R * C; e += kThreads) {
        const int r = e / C;
        const int j = e - r * C;
        const long long t = t0 + r, c = c0 + j;
        if (t < T_ && c < D) copy_in(s + r * C + j, xg + t * D + c);
      }
    }
  };
  auto drain = [&](long long k) {
    const long long t0 = k * R;
    if (vec) {
      for (int e = threadIdx.x; e < R * (C / E); e += kThreads) {
        const int r = e / (C / E);
        const int j = (e - r * (C / E)) * E;
        const long long t = t0 + r, c = c0 + j;
        if (t < T_ && c < D)
          *reinterpret_cast<uint4*>(og + t * D + c) =
              *reinterpret_cast<const uint4*>(otile + r * C + j);
      }
    } else {
      for (int e = threadIdx.x; e < R * C; e += kThreads) {
        const int r = e / C;
        const int j = e - r * C;
        const long long t = t0 + r, c = c0 + j;
        if (t < T_ && c < D) og[t * D + c] = otile[r * C + j];
      }
    }
  };

  const long long col = c0 + threadIdx.x;
  const bool mine = threadIdx.x < C && col < D;  // a consumer: one column
  T carry = identity;
  if (mine && init != nullptr) carry = init[g * D + col];

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) fill(k);
    cp_async_commit();
  }
  for (long long k = 0; k < tiles; ++k) {
    if (k + kStages - 1 < tiles) fill(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile k has landed (this thread's part)
    __syncthreads();  // ... and every thread's; the last output tile is out
    if (mine) {
      const T* s = ring + (k % kStages) * (R * C) + threadIdx.x;
      T* o = otile + threadIdx.x;
      const int rows = T_ - k * R < R ? (int)(T_ - k * R) : R;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const T v = s[r * C];
        if (exclusive) {
          o[r * C] = carry;
          carry = F::f(carry, v);
        } else {
          carry = F::f(carry, v);
          o[r * C] = carry;
        }
      }
    }
    __syncthreads();  // the output tile is whole; tile k's stage is free
    if (og != nullptr) drain(k);
  }
  if (mine && fin != nullptr) fin[g * D + col] = carry;
}

// ---- launching -----------------------------------------------------------

struct MonoidArgs {
  const void* x;
  const void* init;
  void* out;
  void* fin;
  int exclusive;
  long long G, T, D;
  void* scratch;
  cudaStream_t s;
};

struct Lookback {
  template <class T, class F>
  static int go(const MonoidArgs& a, T identity) {
    const long long per_group = (a.T + kTile - 1) / kTile;
    const long long tiles = a.G * per_group;
    if (tiles > INT_MAX) return ERR_TOO_LARGE;  // the counter is an int
    char* base = static_cast<char*>(a.scratch);
    int* counter = reinterpret_cast<int*>(base);
    int* flags = reinterpret_cast<int*>(base + 16);
    T* agg = reinterpret_cast<T*>(base + 16 + round16(4 * tiles));
    T* incl = agg + tiles;
    lookback_scan_kernel<T, F><<<(unsigned)tiles, kThreads, 0, a.s>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.init),
        static_cast<T*>(a.out), static_cast<T*>(a.fin), identity, a.exclusive,
        a.T, per_group, counter, flags, agg, incl);
    return (int)cudaGetLastError();
  }
};

struct Strip {
  template <class T, class F>
  static int go(const MonoidArgs& a, T identity) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        strip_scan_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes);
    if (attr != cudaSuccess) return (int)attr;
    constexpr long long C = kStripBytes / sizeof(T);
    const long long strips = (a.D + C - 1) / C;
    if (a.G * strips > INT_MAX) return ERR_TOO_LARGE;
    const int vec = (a.D * (long long)sizeof(T)) % 16 == 0 && aligned16(a.x) &&
                    aligned16(a.out);
    strip_scan_kernel<T, F><<<(unsigned)(a.G * strips), kThreads, kRingBytes, a.s>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.init),
        static_cast<T*>(a.out), static_cast<T*>(a.fin), identity, a.exclusive,
        a.T, a.D, strips, vec);
    return (int)cudaGetLastError();
  }
};

// The identity of ⊕ at T: 0 for add and xor, 1 for mul, the lowest
// value for max (-inf for floats), the highest for min.
template <class T>
struct Limits;
template <>
struct Limits<int32_t> {
  static int32_t lo() { return INT32_MIN; }
  static int32_t hi() { return INT32_MAX; }
  static int32_t one() { return 1; }
  static int32_t zero() { return 0; }
};
template <>
struct Limits<int64_t> {
  static int64_t lo() { return INT64_MIN; }
  static int64_t hi() { return INT64_MAX; }
  static int64_t one() { return 1; }
  static int64_t zero() { return 0; }
};
template <>
struct Limits<float> {
  static float lo() { return -__builtin_huge_valf(); }
  static float hi() { return __builtin_huge_valf(); }
  static float one() { return 1.0f; }
  static float zero() { return 0.0f; }
};
template <>
struct Limits<double> {
  static double lo() { return -__builtin_huge_val(); }
  static double hi() { return __builtin_huge_val(); }
  static double one() { return 1.0; }
  static double zero() { return 0.0; }
};
template <>
struct Limits<bf16> {
  static bf16 lo() { return __float2bfloat16_rn(-__builtin_huge_valf()); }
  static bf16 hi() { return __float2bfloat16_rn(__builtin_huge_valf()); }
  static bf16 one() { return __float2bfloat16_rn(1.0f); }
  static bf16 zero() { return __float2bfloat16_rn(0.0f); }
};

template <class T, class L>
int monoid_by_op(int op, const MonoidArgs& a) {
  typedef Limits<T> Lim;
  switch (op) {
    case OP_ADD: return L::template go<T, OpAdd>(a, Lim::zero());
    case OP_MUL: return L::template go<T, OpMul>(a, Lim::one());
    case OP_MAX: return L::template go<T, OpMax>(a, Lim::lo());
    case OP_MIN: return L::template go<T, OpMin>(a, Lim::hi());
    default: return ERR_UNSUPPORTED;
  }
}

template <class L>
int monoid_ints(int op, int dt, const MonoidArgs& a) {
  if (op == OP_XOR) {
    if (dt == DT_I32) return L::template go<int32_t, OpXor>(a, 0);
    if (dt == DT_I64) return L::template go<int64_t, OpXor>(a, 0);
    return ERR_UNSUPPORTED;
  }
  if (dt == DT_I32) return monoid_by_op<int32_t, L>(op, a);
  if (dt == DT_I64) return monoid_by_op<int64_t, L>(op, a);
  return ERR_UNSUPPORTED;
}

template <class L>
int monoid_all(int op, int dt, const MonoidArgs& a) {
  switch (dt) {
    case DT_I32:
    case DT_I64: return monoid_ints<L>(op, dt, a);
    case DT_F32: return monoid_by_op<float, L>(op, a);
    case DT_F64: return monoid_by_op<double, L>(op, a);
    case DT_BF16: return monoid_by_op<bf16, L>(op, a);
    default: return ERR_UNSUPPORTED;
  }
}

// The affine monoid, lo then hi: (a_hi·a_lo, a_hi·b_lo + b_hi).  The
// carry is (A, h); row t composes (a_t, b_t) on top of it.
template <class T>
__global__ void __launch_bounds__(kThreads)
affine_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ a0, const T* __restrict__ h0,
                    T* __restrict__ a_out, T* __restrict__ h_out,
                    T* __restrict__ a_fin, T* __restrict__ h_fin,
                    int exclusive, long long T_, long long D, long long cols) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long g = c / D;
  const long long j = c - g * D;
  const long long base = g * T_ * D + j;
  T A = a0 == nullptr ? T(1) : a0[c];
  T h = h0 == nullptr ? T(0) : h0[c];
#pragma unroll 8
  for (long long t = 0; t < T_; ++t) {
    const long long i = base + t * D;
    const T at = a[i];
    const T bt = b[i];
    if (exclusive) {
      if (a_out != nullptr) a_out[i] = A;
      if (h_out != nullptr) h_out[i] = h;
    }
    h = add_(mul_(at, h), bt);
    A = mul_(at, A);
    if (!exclusive) {
      if (a_out != nullptr) a_out[i] = A;
      if (h_out != nullptr) h_out[i] = h;
    }
  }
  if (a_fin != nullptr) a_fin[c] = A;
  if (h_fin != nullptr) h_fin[c] = h;
}

unsigned blocks_for(long long cols) {
  return (unsigned)((cols + kThreads - 1) / kThreads);
}

template <class T>
int launch_affine(const void* a, const void* b, const void* a0, const void* h0,
                  void* a_out, void* h_out, void* a_fin, void* h_fin,
                  int exclusive, long long G, long long T_, long long D,
                  cudaStream_t s) {
  const long long cols = G * D;
  affine_chunk_kernel<T><<<blocks_for(cols), kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(a0), static_cast<const T*>(h0),
      static_cast<T*>(a_out), static_cast<T*>(h_out), static_cast<T*>(a_fin),
      static_cast<T*>(h_fin), exclusive, T_, D, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 on
// success), or ERR_UNSUPPORTED / ERR_TOO_LARGE without launching.
// Buffers are contiguous: x, a, b and the trajectories (G, T, D); init,
// h0, a0 and the finals (G, D).  A null optional pointer means
// "identity" for an input and "not wanted" for an output.

// Bytes of zeroed scratch cs_monoid needs for `regime` at (G, T, D): the
// look-back's tile counter and status words (0 where it needs none).
long long cs_monoid_scratch_bytes(int regime, long long G, long long T,
                                  long long D) {
  if (regime != REGIME_LOOKBACK || G <= 0 || T <= 0 || D != 1) return 0;
  return lookback_scratch_bytes(lookback_tiles(G, T));
}

// regime: REGIME_LOOKBACK (0, "A": an integer ⊕ with D = 1) or
// REGIME_STRIP (1, "B": any ⊕, any D).  One launch either way.
int cs_monoid(int op, int dt, int regime, const void* x, const void* init,
              void* out, void* fin, int exclusive, long long G, long long T,
              long long D, void* scratch, void* stream) {
  if (G <= 0 || D <= 0) return 0;
  const MonoidArgs a{x, init, out, fin, exclusive, G, T, D, scratch,
                     (cudaStream_t)stream};
  if (regime == REGIME_LOOKBACK) {
    if (D != 1 || (dt != DT_I32 && dt != DT_I64)) return ERR_UNSUPPORTED;
    if (T > 0) {
      if (scratch == nullptr) return ERR_UNSUPPORTED;
      return monoid_ints<Lookback>(op, dt, a);
    }
    // no tile to scan: the strip kernel writes the finals
  } else if (regime != REGIME_STRIP) {
    return ERR_UNSUPPORTED;
  }
  return monoid_all<Strip>(op, dt, a);
}

int cs_affine(int dt, const void* a, const void* b, const void* a0,
              const void* h0, void* a_out, void* h_out, void* a_fin,
              void* h_fin, int exclusive, long long G, long long T,
              long long D, void* stream) {
  if (G <= 0 || D <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dt == DT_F32)
    return launch_affine<float>(a, b, a0, h0, a_out, h_out, a_fin, h_fin,
                                exclusive, G, T, D, s);
  if (dt == DT_F64)
    return launch_affine<double>(a, b, a0, h0, a_out, h_out, a_fin, h_fin,
                                 exclusive, G, T, D, s);
  return ERR_UNSUPPORTED;
}

}  // extern "C"
