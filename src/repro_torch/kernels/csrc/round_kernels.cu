// Round kernels of the stacked-rank scan executor, for Hopper (sm_90a).
//
// One scan round updates every rank's payload with a masked ⊕.  On one
// card the p ranks sit on a leading rank axis, so each operand is a
// (p, n) row-major buffer (row stride `rs`; 0 broadcasts one row to
// every rank) and the per-rank mask is an int32 (p,) tensor.  Row `r`
// of the output belongs to rank r.
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
// design reads each operand once and writes each output once: no
// padding copies (the ragged tail is bounds-checked), a broadcast
// operand is read through a zero row stride instead of being expanded,
// and the mask is read once per block, so every branch is uniform.
//
// Rounding: float ⊕ use the _rn intrinsics, so no multiply-add is ever
// contracted into an FMA; bf16 computes in fp32 and rounds once to bf16.
// That is what PyTorch's own elementwise kernels do, so each kernel is
// bit-identical to its plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_ADD = 0, OP_MUL = 1, OP_MAX = 2, OP_MIN = 3, OP_XOR = 4,
       OP_AFFINE = 5 };
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3, DT_BF16 = 4 };
enum { ERR_UNSUPPORTED = 10001, ERR_TOO_MANY_RANKS = 10002 };

constexpr int kThreads = 256;

typedef __nv_bfloat16 bf16;

// ---- the elementwise ⊕ at each type --------------------------------------

__device__ __forceinline__ int32_t add_(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int64_t add_(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ bf16 add_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ int32_t mul_(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int64_t mul_(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ bf16 mul_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}

// max/min propagate NaN like torch.maximum/torch.minimum
__device__ __forceinline__ int32_t max_(int32_t a, int32_t b) { return a < b ? b : a; }
__device__ __forceinline__ int64_t max_(int64_t a, int64_t b) { return a < b ? b : a; }
__device__ __forceinline__ float max_(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ double max_(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmax(a, b));
}
__device__ __forceinline__ bf16 max_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(max_(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ int32_t min_(int32_t a, int32_t b) { return b < a ? b : a; }
__device__ __forceinline__ int64_t min_(int64_t a, int64_t b) { return b < a ? b : a; }
__device__ __forceinline__ float min_(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ double min_(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmin(a, b));
}
__device__ __forceinline__ bf16 min_(bf16 a, bf16 b) {
  return __float2bfloat16_rn(min_(__bfloat162float(a), __bfloat162float(b)));
}

struct OpAdd { template <class T> __device__ static T f(T a, T b) { return add_(a, b); } };
struct OpMul { template <class T> __device__ static T f(T a, T b) { return mul_(a, b); } };
struct OpMax { template <class T> __device__ static T f(T a, T b) { return max_(a, b); } };
struct OpMin { template <class T> __device__ static T f(T a, T b) { return min_(a, b); } };
struct OpXor { template <class T> __device__ static T f(T a, T b) { return a ^ b; } };

// ---- operands: one buffer per leaf, a row stride for the rank axis -------

struct In {
  const void* x;  // the (first) leaf
  const void* y;  // the affine b-leaf (unused by elementwise ⊕)
  long long rs;   // elements between two ranks' rows; 0 broadcasts
};

struct Out {
  void* x;
  void* y;
};

template <class T, class F>
struct Elem {
  typedef T V;
  __device__ static V load(const In& a, long long row, long long j) {
    return static_cast<const T*>(a.x)[row * a.rs + j];
  }
  __device__ static void store(const Out& o, long long i, const V& v) {
    static_cast<T*>(o.x)[i] = v;
  }
  __device__ static V op(const V& lo, const V& hi) { return F::f(lo, hi); }
};

template <class T>
struct Pair {
  T a, b;
};

// The affine monoid: (hi ∘ lo) = (a_hi·a_lo, a_hi·b_lo + b_hi).
template <class T>
struct Affine {
  typedef Pair<T> V;
  __device__ static V load(const In& a, long long row, long long j) {
    const long long i = row * a.rs + j;
    V v;
    v.a = static_cast<const T*>(a.x)[i];
    v.b = static_cast<const T*>(a.y)[i];
    return v;
  }
  __device__ static void store(const Out& o, long long i, const V& v) {
    static_cast<T*>(o.x)[i] = v.a;
    static_cast<T*>(o.y)[i] = v.b;
  }
  __device__ static V op(const V& lo, const V& hi) {
    V r;
    r.a = mul_(hi.a, lo.a);
    r.b = add_(mul_(hi.a, lo.b), hi.b);
    return r;
  }
};

// ---- the three templates: blockIdx.y is the rank, x strides the row ------

template <class P>
__global__ void __launch_bounds__(kThreads)
combine_kernel(In a, In b, Out o, const int* __restrict__ mask, int else_a,
               long long n) {
  const long long row = blockIdx.y;
  const int keep = mask == nullptr ? 1 : mask[row];
  const long long base = row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (keep) {
    for (; j < n; j += stride)
      P::store(o, base + j, P::op(P::load(a, row, j), P::load(b, row, j)));
  } else if (else_a) {
    for (; j < n; j += stride) P::store(o, base + j, P::load(a, row, j));
  } else {
    for (; j < n; j += stride) P::store(o, base + j, P::load(b, row, j));
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(In r, In w, Out o, const int* __restrict__ low, long long n) {
  const long long row = blockIdx.y;
  const int lo = low[row];
  const long long base = row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lo) {
    for (; j < n; j += stride)
      P::store(o, base + j, P::op(P::load(r, row, j), P::load(w, row, j)));
  } else {
    for (; j < n; j += stride)
      P::store(o, base + j, P::op(P::load(w, row, j), P::load(r, row, j)));
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(In r, In w, In pf, Out ow, Out op, const int* __restrict__ low,
                   int commutative, long long n) {
  const long long row = blockIdx.y;
  const int lo = low[row];
  const long long base = row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lo) {
    for (; j < n; j += stride) {
      const typename P::V vr = P::load(r, row, j);
      P::store(ow, base + j, P::op(vr, P::load(w, row, j)));
      P::store(op, base + j, P::op(vr, P::load(pf, row, j)));
    }
  } else if (commutative) {
    for (; j < n; j += stride) {
      P::store(ow, base + j, P::op(P::load(r, row, j), P::load(w, row, j)));
      P::store(op, base + j, P::load(pf, row, j));
    }
  } else {
    for (; j < n; j += stride) {
      P::store(ow, base + j, P::op(P::load(w, row, j), P::load(r, row, j)));
      P::store(op, base + j, P::load(pf, row, j));
    }
  }
}

// Enough blocks to fill the card (about 2048 in all), at most one
// thread per element of a row.
dim3 grid_for(long long p, long long n) {
  long long per_row = (2048 + p - 1) / p;
  long long want = (n + kThreads - 1) / kThreads;
  long long gx = want < per_row ? want : per_row;
  if (gx < 1) gx = 1;
  return dim3((unsigned)gx, (unsigned)p);
}

struct CombineLaunch {
  In a, b;
  Out o;
  const int* mask;
  int else_a;
  long long p, n;
  cudaStream_t s;
  template <class P> int go() {
    combine_kernel<P><<<grid_for(p, n), kThreads, 0, s>>>(a, b, o, mask, else_a, n);
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
    exchange_kernel<P><<<grid_for(p, n), kThreads, 0, s>>>(r, w, o, low, n);
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
    scan_reduce_kernel<P><<<grid_for(p, n), kThreads, 0, s>>>(r, w, pf, ow, op, low,
                                                              commutative, n);
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

int check_shape(long long p, long long n) {
  if (p > 65535) return ERR_TOO_MANY_RANKS;  // ranks ride gridDim.y
  return 0;
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 on
// success), or ERR_UNSUPPORTED / ERR_TOO_MANY_RANKS without launching.

int rk_combine(int op, int dt, const void* a0, const void* a1, long long a_rs,
               const void* b0, const void* b1, long long b_rs, void* o0, void* o1,
               const int* mask, int else_a, long long p, long long n,
               void* stream) {
  if (p <= 0 || n <= 0) return 0;
  if (int e = check_shape(p, n)) return e;
  CombineLaunch L{In{a0, a1, a_rs}, In{b0, b1, b_rs}, Out{o0, o1}, mask, else_a,
                  p, n, (cudaStream_t)stream};
  return dispatch(op, dt, L);
}

int rk_exchange(int op, int dt, const void* r0, const void* r1, long long r_rs,
                const void* w0, const void* w1, long long w_rs, void* o0, void* o1,
                const int* low, long long p, long long n, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  if (int e = check_shape(p, n)) return e;
  ExchangeLaunch L{In{r0, r1, r_rs}, In{w0, w1, w_rs}, Out{o0, o1}, low, p, n,
                   (cudaStream_t)stream};
  return dispatch(op, dt, L);
}

int rk_scan_reduce(int op, int dt, const void* r0, const void* r1, long long r_rs,
                   const void* w0, const void* w1, long long w_rs,
                   const void* p0, const void* p1, long long p_rs,
                   void* ow0, void* ow1, void* op0, void* op1, const int* low,
                   int commutative, long long p, long long n, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  if (int e = check_shape(p, n)) return e;
  ScanReduceLaunch L{In{r0, r1, r_rs}, In{w0, w1, w_rs}, In{p0, p1, p_rs},
                     Out{ow0, ow1}, Out{op0, op1}, low, commutative, p, n,
                     (cudaStream_t)stream};
  return dispatch(op, dt, L);
}

}  // extern "C"
