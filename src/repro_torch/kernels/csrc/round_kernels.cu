// Round kernels of the stacked-rank scan executor, for Hopper (sm_90a).
//
// One scan round updates every rank's payload with a masked ⊕.  On one
// card the p ranks sit on a leading rank axis, so each operand is a
// (p, n) row-major buffer (row stride `rs`; 0 broadcasts one row to
// every rank) and the per-rank mask is an int32 (p,) tensor.  Row `r`
// of the output belongs to rank r.  An operand may also carry a row
// table `src` (int32 (p,)): rank r then reads row src[r] of the buffer,
// or zeros where src[r] < 0.  That is a round's peer exchange (rank r
// receives rank r−skip's row, or rank r^skip's), read in place instead
// of gathered into a copy first.
//
// Three templates, each instantiated over the elementwise ⊕ (add, mul,
// max, min; xor for ints) at int32, int64, fp32, fp64 and bf16, and over
// the affine pair (fp32, fp64), whose (a, b) leaves are two buffers:
//
//   combine      o = a⊕b, or with a mask  o = keep[r] ? a⊕b : (else_a ? a : b)
//   exchange     o = low[r] ? r⊕w : w⊕r
//   scan_reduce  w' = (low[r] || commutative) ? r⊕w : w⊕r;  p' = low[r] ? r⊕p : p
//
// They replace the Pallas bodies of kernels/scan_engine.py in the JAX
// package: _combine_kernel, _masked_combine_kernel and
// _affine_combine_kernel / _affine_masked_kernel (combine),
// _exchange_kernel and _affine_exchange_kernel (exchange),
// _scan_reduce_kernel and _affine_scan_reduce_kernel (scan_reduce),
// launched there through _round_call.
//
// Bound: bytes.  combine moves 3·p·n·itemsize, exchange the same,
// scan_reduce 5·p·n·itemsize; the affine instances twice those.  The
// design reads each operand once and writes each output once:
//   - no padding copies (the ragged tail is bounds-checked), a
//     broadcast operand is read through a zero row stride, and a peer's
//     row through the row table, so no operand is expanded or gathered;
//   - work comes in tiles of one row (up to kThreads·U·W elements); the mask
//     and the row tables are read once per tile, so every branch is
//     uniform, and a masked-off rank never reads the operand it does
//     not keep;
//   - where a tile's rows are 16-byte aligned, each thread moves 16
//     bytes per load and store, with U such vectors in flight (4 for
//     the elementwise ⊕, 2 for the affine pair); other rows, and the
//     ragged tail, go element by element;
//   - one block per tile: the hardware's block scheduler keeps the SMs
//     full and evenly loaded.  (A grid of whole rows leaves SMs unevenly
//     loaded where p is near the number of resident blocks, as at
//     p = 512 on 132 SMs; a persistent grid of one wave of resident
//     blocks walking the tiles moved fewer bytes per second than one
//     block per tile on the H100.)
//
// Rounding: the ⊕ of monoid_ops.cuh, so each kernel is bit-identical to
// its plain PyTorch version.

#include <limits.h>
#include <string.h>

#include "monoid_ops.cuh"

namespace {

constexpr int kThreads = 256;

// ---- operands: one buffer per leaf, a row stride, an optional row table ---

struct In {
  const void* x;    // the (first) leaf
  const void* y;    // the affine b-leaf (unused by elementwise ⊕)
  long long rs;     // elements between two ranks' rows; 0 broadcasts
  const int* src;   // rank r reads row src[r] (zeros where < 0); null: row r
  long long rows;   // rows of the buffer: a table entry must lie below
};

struct Out {
  void* x;
  void* y;
};

// One operand's row for a tile's rank: its leaves' base pointers, or
// zero-fill.
template <class T>
struct Row {
  const T* x;
  const T* y;
  int zero;
};

template <class T>
__device__ __forceinline__ Row<T> row_of(const In& a, long long r) {
  const long long s = a.src == nullptr ? r : (long long)a.src[r];
  if (s >= a.rows) __trap();  // a table entry past the buffer: stop, as an index assert
  Row<T> v;
  v.zero = s < 0;
  const long long off = v.zero ? 0 : s * a.rs;
  v.x = static_cast<const T*>(a.x) + off;
  v.y = a.y == nullptr ? nullptr : static_cast<const T*>(a.y) + off;
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class T>
__device__ __forceinline__ T zero_of() {
  T v;
  memset(&v, 0, sizeof(T));  // +0 at every type
  return v;
}

// A 16-byte vector of W elements.
template <class T>
struct Vec {
  enum { W = 16 / sizeof(T) };
  uint4 u;
  __device__ __forceinline__ T get(int i) const {
    T v;
    memcpy(&v, reinterpret_cast<const char*>(&u) + i * sizeof(T), sizeof(T));
    return v;
  }
  __device__ __forceinline__ void set(int i, T v) {
    memcpy(reinterpret_cast<char*>(&u) + i * sizeof(T), &v, sizeof(T));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 zero16() { return make_uint4(0, 0, 0, 0); }

// Each policy P names its element V, its vector Pack of W elements, and
// U, the vectors each thread keeps in flight.
template <class T, class F>
struct Elem {
  typedef T S;
  typedef T V;
  enum { W = Vec<T>::W, U = 4 };
  struct Pack {
    Vec<T> a;
  };
  __device__ static V load(const Row<T>& r, long long j) {
    return r.zero ? zero_of<T>() : r.x[j];
  }
  __device__ static void store(const Out& o, long long i, const V& v) {
    static_cast<T*>(o.x)[i] = v;
  }
  __device__ static bool aligned(const Row<T>& r) { return r.zero || aligned16(r.x); }
  __device__ static bool aligned(const Out& o, long long i) {
    return aligned16(static_cast<T*>(o.x) + i);
  }
  __device__ static Pack load_pack(const Row<T>& r, long long j) {
    Pack p;
    p.a.u = r.zero ? zero16() : load16(r.x + j);
    return p;
  }
  __device__ static void store_pack(const Out& o, long long i, const Pack& p) {
    *reinterpret_cast<uint4*>(static_cast<T*>(o.x) + i) = p.a.u;
  }
  __device__ static V get(const Pack& p, int i) { return p.a.get(i); }
  __device__ static void set(Pack& p, int i, const V& v) { p.a.set(i, v); }
  __device__ static V op(const V& lo, const V& hi) { return F::f(lo, hi); }
};

template <class T>
struct Pair {
  T a, b;
};

// The affine monoid: (hi ∘ lo) = (a_hi·a_lo, a_hi·b_lo + b_hi).
template <class T>
struct Affine {
  typedef T S;
  typedef Pair<T> V;
  enum { W = Vec<T>::W, U = 2 };
  struct Pack {
    Vec<T> a, b;
  };
  __device__ static V load(const Row<T>& r, long long j) {
    V v;
    v.a = r.zero ? T(0) : r.x[j];
    v.b = r.zero ? T(0) : r.y[j];
    return v;
  }
  __device__ static void store(const Out& o, long long i, const V& v) {
    static_cast<T*>(o.x)[i] = v.a;
    static_cast<T*>(o.y)[i] = v.b;
  }
  __device__ static bool aligned(const Row<T>& r) {
    return r.zero || (aligned16(r.x) && aligned16(r.y));
  }
  __device__ static bool aligned(const Out& o, long long i) {
    return aligned16(static_cast<T*>(o.x) + i) && aligned16(static_cast<T*>(o.y) + i);
  }
  __device__ static Pack load_pack(const Row<T>& r, long long j) {
    Pack p;
    p.a.u = r.zero ? zero16() : load16(r.x + j);
    p.b.u = r.zero ? zero16() : load16(r.y + j);
    return p;
  }
  __device__ static void store_pack(const Out& o, long long i, const Pack& p) {
    *reinterpret_cast<uint4*>(static_cast<T*>(o.x) + i) = p.a.u;
    *reinterpret_cast<uint4*>(static_cast<T*>(o.y) + i) = p.b.u;
  }
  __device__ static V get(const Pack& p, int i) {
    V v;
    v.a = p.a.get(i);
    v.b = p.b.get(i);
    return v;
  }
  __device__ static void set(Pack& p, int i, const V& v) {
    p.a.set(i, v.a);
    p.b.set(i, v.b);
  }
  __device__ static V op(const V& lo, const V& hi) {
    V r;
    r.a = mul_(hi.a, lo.a);
    r.b = add_(mul_(hi.a, lo.b), hi.b);
    return r;
  }
};

// ---- one tile: NI operand rows in, NO output rows out --------------------
//
// A tile is blockDim.x·U·W elements of one row: thread i takes vectors
// i, i + blockDim.x, … (U of them, all loads first, so each warp's
// loads coalesce), and the elements past the last whole vector one at a
// time.  `fn(x, y)` maps NI elements to NO.

template <class P, int NI, int NO, class Fn>
__device__ __forceinline__ void stream_tile(const Row<typename P::S> (&in)[NI],
                                            const Out (&out)[NO], long long ob,
                                            long long j0, long long j1, Fn fn) {
  typedef typename P::V V;
  typedef typename P::Pack Pack;
  bool vec = true;
#pragma unroll
  for (int i = 0; i < NI; ++i) vec = vec && P::aligned(in[i]);
#pragma unroll
  for (int o = 0; o < NO; ++o) vec = vec && P::aligned(out[o], ob);
  long long head = j0;
  if (vec) {
    const long long np = (j1 - j0) / P::W;
    Pack x[P::U][NI];
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const long long k = threadIdx.x + (long long)u * blockDim.x;
      if (k < np) {
#pragma unroll
        for (int i = 0; i < NI; ++i) x[u][i] = P::load_pack(in[i], j0 + k * P::W);
      }
    }
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const long long k = threadIdx.x + (long long)u * blockDim.x;
      if (k < np) {
        Pack y[NO];
#pragma unroll
        for (int w = 0; w < P::W; ++w) {
          V xs[NI], ys[NO];
#pragma unroll
          for (int i = 0; i < NI; ++i) xs[i] = P::get(x[u][i], w);
          fn(xs, ys);
#pragma unroll
          for (int o = 0; o < NO; ++o) P::set(y[o], w, ys[o]);
        }
#pragma unroll
        for (int o = 0; o < NO; ++o) P::store_pack(out[o], ob + j0 + k * P::W, y[o]);
      }
    }
    head = j0 + np * P::W;
  }
  for (long long j = head + threadIdx.x; j < j1; j += blockDim.x) {
    V xs[NI], ys[NO];
#pragma unroll
    for (int i = 0; i < NI; ++i) xs[i] = P::load(in[i], j);
    fn(xs, ys);
#pragma unroll
    for (int o = 0; o < NO; ++o) P::store(out[o], ob + j, ys[o]);
  }
}

// The tiles of a (p, n) launch, tiles_per_row to a row; block b takes
// tile b (and b + gridDim.x, … where the tiles outnumber the grid).
struct Tile {
  long long row, j0, j1;
};

template <class P>
__device__ __forceinline__ Tile tile_at(long long t, long long tiles_per_row,
                                        long long n) {
  const long long size = (long long)blockDim.x * P::U * P::W;
  Tile x;
  x.row = t / tiles_per_row;
  x.j0 = (t - x.row * tiles_per_row) * size;
  x.j1 = x.j0 + size < n ? x.j0 + size : n;
  return x;
}

// ---- the three templates -------------------------------------------------

template <class P>
__global__ void __launch_bounds__(kThreads)
combine_kernel(In a, In b, Out o, const int* __restrict__ mask, int else_a,
               long long n, long long tiles_per_row, long long tiles) {
  typedef typename P::S S;
  typedef typename P::V V;
  const Out outs[1] = {o};
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile x = tile_at<P>(t, tiles_per_row, n);
    const long long ob = x.row * n;
    if (mask == nullptr || mask[x.row]) {
      const Row<S> in[2] = {row_of<S>(a, x.row), row_of<S>(b, x.row)};
      stream_tile<P, 2, 1>(in, outs, ob, x.j0, x.j1,
                           [](const V* v, V* y) { y[0] = P::op(v[0], v[1]); });
    } else {  // a masked-off rank reads only the operand it keeps
      const Row<S> in[1] = {else_a ? row_of<S>(a, x.row) : row_of<S>(b, x.row)};
      stream_tile<P, 1, 1>(in, outs, ob, x.j0, x.j1,
                           [](const V* v, V* y) { y[0] = v[0]; });
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(In r, In w, Out o, const int* __restrict__ low, long long n,
                long long tiles_per_row, long long tiles) {
  typedef typename P::S S;
  typedef typename P::V V;
  const Out outs[1] = {o};
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile x = tile_at<P>(t, tiles_per_row, n);
    const Row<S> in[2] = {row_of<S>(r, x.row), row_of<S>(w, x.row)};
    if (low[x.row]) {
      stream_tile<P, 2, 1>(in, outs, x.row * n, x.j0, x.j1,
                           [](const V* v, V* y) { y[0] = P::op(v[0], v[1]); });
    } else {
      stream_tile<P, 2, 1>(in, outs, x.row * n, x.j0, x.j1,
                           [](const V* v, V* y) { y[0] = P::op(v[1], v[0]); });
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(In r, In w, In pf, Out ow, Out op, const int* __restrict__ low,
                   int commutative, long long n, long long tiles_per_row,
                   long long tiles) {
  typedef typename P::S S;
  typedef typename P::V V;
  const Out outs[2] = {ow, op};
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile x = tile_at<P>(t, tiles_per_row, n);
    const Row<S> in[3] = {row_of<S>(r, x.row), row_of<S>(w, x.row),
                          row_of<S>(pf, x.row)};
    if (low[x.row]) {
      stream_tile<P, 3, 2>(in, outs, x.row * n, x.j0, x.j1, [](const V* v, V* y) {
        y[0] = P::op(v[0], v[1]);
        y[1] = P::op(v[0], v[2]);
      });
    } else if (commutative) {
      stream_tile<P, 3, 2>(in, outs, x.row * n, x.j0, x.j1, [](const V* v, V* y) {
        y[0] = P::op(v[0], v[1]);
        y[1] = v[2];
      });
    } else {
      stream_tile<P, 3, 2>(in, outs, x.row * n, x.j0, x.j1, [](const V* v, V* y) {
        y[0] = P::op(v[1], v[0]);
        y[1] = v[2];
      });
    }
  }
}

// ---- the grid: one block per tile ---------------------------------------

// The (p, n) launch's tiles, one block each (the hardware's block
// scheduler keeps every SM full and balances them); the blocks' loop
// covers any tiles past the grid's limit.  A block has kThreads
// threads, or as many warps as a shorter row needs, so short rows (a
// scan of a few elements per rank) do not launch idle threads.
struct Grid {
  long long tiles_per_row, tiles;
  unsigned blocks, threads;
};

template <class P>
Grid grid_for(long long p, long long n) {
  const long long per_thread = P::U * P::W;
  long long threads = (n + per_thread - 1) / per_thread;
  threads = threads < kThreads ? (threads + 31) / 32 * 32 : kThreads;
  Grid g;
  g.threads = (unsigned)threads;
  g.tiles_per_row = (n + threads * per_thread - 1) / (threads * per_thread);
  g.tiles = p * g.tiles_per_row;
  g.blocks = (unsigned)(g.tiles < INT_MAX ? g.tiles : INT_MAX);
  return g;
}

struct CombineLaunch {
  In a, b;
  Out o;
  const int* mask;
  int else_a;
  long long p, n;
  cudaStream_t s;
  template <class P> int go() {
    const Grid g = grid_for<P>(p, n);
    combine_kernel<P><<<g.blocks, g.threads, 0, s>>>(a, b, o, mask, else_a, n,
                                                    g.tiles_per_row, g.tiles);
    return (int)cudaGetLastError();
  }
};

struct ExchangeLaunch {
  In r, w;
  Out o;
  const int* low;
  long long p, n;
  cudaStream_t s;
  template <class P> int go() {
    const Grid g = grid_for<P>(p, n);
    exchange_kernel<P><<<g.blocks, g.threads, 0, s>>>(r, w, o, low, n,
                                                     g.tiles_per_row, g.tiles);
    return (int)cudaGetLastError();
  }
};

struct ScanReduceLaunch {
  In r, w, pf;
  Out ow, op;
  const int* low;
  int commutative;
  long long p, n;
  cudaStream_t s;
  template <class P> int go() {
    const Grid g = grid_for<P>(p, n);
    scan_reduce_kernel<P><<<g.blocks, g.threads, 0, s>>>(
        r, w, pf, ow, op, low, commutative, n, g.tiles_per_row, g.tiles);
    return (int)cudaGetLastError();
  }
};

template <class T, class L>
int by_op(int op, L& launch) {
  switch (op) {
    case OP_ADD: return launch.template go<Elem<T, OpAdd> >();
    case OP_MUL: return launch.template go<Elem<T, OpMul> >();
    case OP_MAX: return launch.template go<Elem<T, OpMax> >();
    case OP_MIN: return launch.template go<Elem<T, OpMin> >();
    default: return ERR_UNSUPPORTED;
  }
}

template <class L>
int dispatch(int op, int dt, L& launch) {
  if (op == OP_AFFINE) {
    if (dt == DT_F32) return launch.template go<Affine<float> >();
    if (dt == DT_F64) return launch.template go<Affine<double> >();
    return ERR_UNSUPPORTED;
  }
  if (op == OP_XOR) {
    if (dt == DT_I32) return launch.template go<Elem<int32_t, OpXor> >();
    if (dt == DT_I64) return launch.template go<Elem<int64_t, OpXor> >();
    return ERR_UNSUPPORTED;
  }
  switch (dt) {
    case DT_I32: return by_op<int32_t>(op, launch);
    case DT_I64: return by_op<int64_t>(op, launch);
    case DT_F32: return by_op<float>(op, launch);
    case DT_F64: return by_op<double>(op, launch);
    case DT_BF16: return by_op<bf16>(op, launch);
    default: return ERR_UNSUPPORTED;
  }
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 on
// success), or ERR_UNSUPPORTED without launching.
// Each operand is (leaf0, leaf1, row stride, row table); the row table
// is null or an int32 (p,) buffer whose entries are rows of the operand
// or negative (zeros).

int rk_combine(int op, int dt, const void* a0, const void* a1, long long a_rs,
               const int* a_src, const void* b0, const void* b1, long long b_rs,
               const int* b_src, void* o0, void* o1, const int* mask, int else_a,
               long long p, long long n, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  CombineLaunch L{In{a0, a1, a_rs, a_src, p}, In{b0, b1, b_rs, b_src, p}, Out{o0, o1},
                  mask, else_a, p, n, (cudaStream_t)stream};
  return dispatch(op, dt, L);
}

int rk_exchange(int op, int dt, const void* r0, const void* r1, long long r_rs,
                const int* r_src, const void* w0, const void* w1, long long w_rs,
                const int* w_src, void* o0, void* o1, const int* low, long long p,
                long long n, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  ExchangeLaunch L{In{r0, r1, r_rs, r_src, p}, In{w0, w1, w_rs, w_src, p}, Out{o0, o1},
                   low, p, n, (cudaStream_t)stream};
  return dispatch(op, dt, L);
}

int rk_scan_reduce(int op, int dt, const void* r0, const void* r1, long long r_rs,
                   const int* r_src, const void* w0, const void* w1, long long w_rs,
                   const int* w_src, const void* p0, const void* p1, long long p_rs,
                   const int* p_src, void* ow0, void* ow1, void* op0, void* op1,
                   const int* low, int commutative, long long p, long long n,
                   void* stream) {
  if (p <= 0 || n <= 0) return 0;
  ScanReduceLaunch L{In{r0, r1, r_rs, r_src, p}, In{w0, w1, w_rs, w_src, p},
                     In{p0, p1, p_rs, p_src, p}, Out{ow0, ow1}, Out{op0, op1}, low,
                     commutative, p, n, (cudaStream_t)stream};
  return dispatch(op, dt, L);
}

}  // extern "C"
