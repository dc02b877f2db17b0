// The chunked-scan engine for Hopper (sm_90a): a single-pass scan along
// the row axis of (G, T, D) buffers, one thread per (group, column).
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
// The TPU kernel walks row chunks in its sequential grid with the carry
// in VMEM.  Blocks on this card run in no order, so the sequential axis
// becomes a loop inside one thread: each thread owns one (g, column)
// and walks T with the carry in a register, folding left in row order.
// Consecutive threads take consecutive columns of a group, so every
// row's loads and stores are coalesced, and the result is
// deterministic and bit-identical to a plain row loop (the ⊕ of
// monoid_ops.cuh round exactly as PyTorch's elementwise kernels do;
// bf16 rounds the carry after every step).
//
// Bound: bytes.  monoid_exscan moves 2·G·T·D·itemsize; the affine scan
// 3·G·T·D·itemsize plus the h0 and final rows; the summary
// 2·G·T·D·itemsize + 2·G·D·itemsize.  Each input element is read once
// and each output written once.  The loads of a thread do not depend
// on its carry, so the unrolled loop keeps several rows in flight.
// Weak spot: at small G·D (a 1-D scan is D = 1) a few threads walk the
// whole column and the card idles; a reduce-then-scan over row blocks
// is the cure, left for later work.

#include "monoid_ops.cuh"

namespace {

constexpr int kThreads = 256;

template <class T, class F>
__global__ void __launch_bounds__(kThreads)
monoid_chunk_kernel(const T* __restrict__ x, const T* __restrict__ init,
                    T* __restrict__ out, T* __restrict__ fin, T identity,
                    int exclusive, long long T_, long long D, long long cols) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long g = c / D;
  const long long j = c - g * D;
  const T* xp = x + g * T_ * D + j;
  T* op = out == nullptr ? nullptr : out + g * T_ * D + j;
  T carry = init == nullptr ? identity : init[c];
#pragma unroll 8
  for (long long t = 0; t < T_; ++t) {
    const T v = xp[t * D];
    if (exclusive) {
      if (op != nullptr) op[t * D] = carry;
      carry = F::f(carry, v);
    } else {
      carry = F::f(carry, v);
      if (op != nullptr) op[t * D] = carry;
    }
  }
  if (fin != nullptr) fin[c] = carry;
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

template <class T, class F>
int launch_monoid(const void* x, const void* init, void* out, void* fin,
                  T identity, int exclusive, long long G, long long T_,
                  long long D, cudaStream_t s) {
  const long long cols = G * D;
  monoid_chunk_kernel<T, F><<<blocks_for(cols), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(init),
      static_cast<T*>(out), static_cast<T*>(fin), identity, exclusive, T_, D,
      cols);
  return (int)cudaGetLastError();
}

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

template <class T>
int monoid_by_op(int op, const void* x, const void* init, void* out,
                 void* fin, int exclusive, long long G, long long T_,
                 long long D, cudaStream_t s) {
  typedef Limits<T> L;
  switch (op) {
    case OP_ADD:
      return launch_monoid<T, OpAdd>(x, init, out, fin, L::zero(), exclusive,
                                     G, T_, D, s);
    case OP_MUL:
      return launch_monoid<T, OpMul>(x, init, out, fin, L::one(), exclusive,
                                     G, T_, D, s);
    case OP_MAX:
      return launch_monoid<T, OpMax>(x, init, out, fin, L::lo(), exclusive,
                                     G, T_, D, s);
    case OP_MIN:
      return launch_monoid<T, OpMin>(x, init, out, fin, L::hi(), exclusive,
                                     G, T_, D, s);
    default:
      return ERR_UNSUPPORTED;
  }
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
// success), or ERR_UNSUPPORTED without launching.  Buffers are
// contiguous: x, a, b and the trajectories (G, T, D); init, h0, a0 and
// the finals (G, D).  A null optional pointer means "identity" for an
// input and "not wanted" for an output.

int cs_monoid(int op, int dt, const void* x, const void* init, void* out,
              void* fin, int exclusive, long long G, long long T,
              long long D, void* stream) {
  if (G <= 0 || D <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == OP_XOR) {
    if (dt == DT_I32)
      return launch_monoid<int32_t, OpXor>(x, init, out, fin, 0, exclusive, G,
                                           T, D, s);
    if (dt == DT_I64)
      return launch_monoid<int64_t, OpXor>(x, init, out, fin, 0, exclusive, G,
                                           T, D, s);
    return ERR_UNSUPPORTED;
  }
  switch (dt) {
    case DT_I32: return monoid_by_op<int32_t>(op, x, init, out, fin, exclusive, G, T, D, s);
    case DT_I64: return monoid_by_op<int64_t>(op, x, init, out, fin, exclusive, G, T, D, s);
    case DT_F32: return monoid_by_op<float>(op, x, init, out, fin, exclusive, G, T, D, s);
    case DT_F64: return monoid_by_op<double>(op, x, init, out, fin, exclusive, G, T, D, s);
    case DT_BF16: return monoid_by_op<bf16>(op, x, init, out, fin, exclusive, G, T, D, s);
    default: return ERR_UNSUPPORTED;
  }
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
