// The generic monoid scan of the quasiseparable algebra on Hopper (sm_90a):
// kernel B3.
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_scan.py:
// _scan_kernel (line 331), launched by pallas_monoid_scan (line 405,
// pallas_call at line 518): an exclusive scan along n of a monoid whose
// combine is given component by component, forward or reverse, writing only
// the leaves the caller consumes. Here the monoid is a template parameter,
// instantiated for the four monoids of the O(N) algebra:
//
//   Aff<m>      g' = A g + B              [A | B],      m^2 + m components
//   Cong<m>     g' = A g A^T + B          [A | B],      2 m^2
//   Ric<m>      the Riccati covariance flow as a Moebius map
//               (quasisep_common.cuh)     [A | F | G],  3 m^2
//   Cpl<m1,m2>  g' = A g B^T + C          [A | B | C],  m1^2 + m2^2 + m1 m2
//
// for m = 1..4 (Cpl with m1 = m2). Each runs forward or reverse, exclusive
// or inclusive, and writes one leaf: B of the affine and congruence scans
// (the state, which starts at 0), F of the Riccati flow, C of the coupling.
// The affine scan takes r right-hand-side columns that share one
// transition stream: each column is its own Aff<m> scan, on the grid's y
// axis, so the monoid stays m^2 + m wide for any r.
//
// Operands are stacked as in the JAX package: a (k, n) operand holds
// component c of element j at [c * n + j], row-major and contiguous, in
// float32 or float64. The affine loads B and states are (m * r, n), row
// i * r + col; the Riccati flow reads the element's (d, p, q, a), (n),
// (m, n), (m, n), (m * m, n), and forms its Moebius map in the kernel.
//
// Precision. Every combine runs in float64 (Acc) whatever the operands'
// type, as in B1 (see quasisep_loglik.cu): composed in float32, the
// Riccati maps of long spans lose the state. The output is stored in the
// operands' type.
//
// What bounds it: bytes. The sequential recurrence reads each operand once
// and writes the state once: an affine scan with m = 2, r = 1 moves 8
// values per element (32 bytes in float32, 9.6 us at n = 1e6 at 3.35 TB/s)
// for 8 flops (0.12 us at 67 TFLOP/s); the Riccati flow, m = 2, reads 9 and
// writes 4 values for about 60 flops.
//
// Design. The TPU grid runs in order and carries the prefix from one grid
// step to the next in VMEM (pallas_scan.py:11-24). CUDA blocks run in no
// order, so this is B1's chunked multi-pass scan, generic over the monoid:
//
//   1. chunk_pass:  each thread folds kChunk consecutive elements into one
//                   monoid value; a Kogge-Stone scan in shared memory gives
//                   each thread its in-block exclusive prefix, and the last
//                   thread writes the block total.
//   2. scan_totals: one block per column scans the block totals
//                   (exclusive, in place).
//   3. finish_pass: each thread composes its block's and its own prefix,
//                   re-runs its chunk with the same combine and writes the
//                   consumed leaf before (exclusive) or after (inclusive)
//                   each element.
//
// A reverse scan mirrors the index (position j holds element n - 1 - j), as
// B2 does, so the forward combine serves both directions: the suffix
// composition of elements k < l is combine(element l, element k). The
// ragged end is masked; nothing is padded (the TPU launcher pads with
// identities). The cost of this design against the bound: the operands are
// read twice with strided per-thread loads, each column of an affine scan
// re-composes the shared transitions, and every call is three launches.

#include "quasisep_common.cuh"

namespace {

enum Kind { kAff = 0, kCong = 1, kRic = 2, kCpl = 3 };

// ---------------------------------------------------------------- two monoids

// The congruence recurrence g' = A g A^T + B, flattened [A | B].
template <typename T, int M>
struct Cong {
  static constexpr int MM = M * M;
  static constexpr int S = 2 * MM;
  T v[S];

  __device__ static Cong identity() {
    Cong r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < MM && c % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // (A_l A_e, A_l B_e A_l^T + B_l)
  __device__ static Cong combine(const Cong& e, const Cong& l) {
    Cong out;
    T t[MM], u[MM];
    mm<T, M>(l.v, e.v, out.v);
    mm<T, M>(l.v, e.v + MM, t);
    mm_nt<T, M>(t, l.v, u);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[MM + c] = u[c] + l.v[MM + c];
    return out;
  }
};

// The two-sided coupling g' = A g B^T + C with g of shape (M1, M2),
// flattened [A (M1 x M1) | B (M2 x M2) | C (M1 x M2)].
template <typename T, int M1, int M2>
struct Cpl {
  static constexpr int OB = M1 * M1;
  static constexpr int OC = OB + M2 * M2;
  static constexpr int S = OC + M1 * M2;
  T v[S];

  __device__ static Cpl identity() {
    Cpl r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = T(0);
#pragma unroll
    for (int i = 0; i < M1; ++i) r.v[i * (M1 + 1)] = T(1);
#pragma unroll
    for (int i = 0; i < M2; ++i) r.v[OB + i * (M2 + 1)] = T(1);
    return r;
  }

  // (A_l A_e, B_l B_e, A_l C_e B_l^T + C_l)
  __device__ static Cpl combine(const Cpl& e, const Cpl& l) {
    Cpl out;
    mm<T, M1>(l.v, e.v, out.v);
    mm<T, M2>(l.v + OB, e.v + OB, out.v + OB);
    T ac[M1 * M2];
#pragma unroll
    for (int i = 0; i < M1; ++i)
#pragma unroll
      for (int j = 0; j < M2; ++j) {
        T acc = l.v[i * M1] * e.v[OC + j];
#pragma unroll
        for (int k = 1; k < M1; ++k) acc += l.v[i * M1 + k] * e.v[OC + k * M2 + j];
        ac[i * M2 + j] = acc;
      }
#pragma unroll
    for (int i = 0; i < M1; ++i)
#pragma unroll
      for (int j = 0; j < M2; ++j) {
        T acc = l.v[OC + i * M2 + j];
#pragma unroll
        for (int k = 0; k < M2; ++k) acc += ac[i * M2 + k] * l.v[OB + j * M2 + k];
        out.v[OC + i * M2 + j] = acc;
      }
    return out;
  }
};

// ------------------------------------------------- operands of each monoid
//
// An op binds the operand pointers, loads element k of column col as a
// monoid value in Acc, and stores the consumed leaf of a prefix at k.

template <typename S, int M>
struct AffOp {
  using V = Aff<Acc, M>;
  static constexpr int MM = M * M;
  const S* A;
  const S* B;
  S* out;
  long long n;
  int r;

  __device__ V load(long long k, int col) const {
    V x;
#pragma unroll
    for (int c = 0; c < MM; ++c) x.v[c] = Acc(A[c * n + k]);
#pragma unroll
    for (int i = 0; i < M; ++i) x.v[MM + i] = Acc(B[((long long)i * r + col) * n + k]);
    return x;
  }

  __device__ void store(long long k, int col, const V& x) const {
#pragma unroll
    for (int i = 0; i < M; ++i) out[((long long)i * r + col) * n + k] = S(x.v[MM + i]);
  }
};

template <typename S, int M>
struct CongOp {
  using V = Cong<Acc, M>;
  static constexpr int MM = M * M;
  const S* A;
  const S* B;
  S* out;
  long long n;

  __device__ V load(long long k, int) const {
    V x;
#pragma unroll
    for (int c = 0; c < MM; ++c) {
      x.v[c] = Acc(A[c * n + k]);
      x.v[MM + c] = Acc(B[c * n + k]);
    }
    return x;
  }

  __device__ void store(long long k, int, const V& x) const {
#pragma unroll
    for (int c = 0; c < MM; ++c) out[c * n + k] = S(x.v[MM + c]);
  }
};

// The Riccati flow from the element's (d, p, q, a): its Moebius map is
// A = a - q p^T / d, F = q q^T / d, G = -p p^T / d (scan.py:_riccati_scan_s).
template <typename S, int M>
struct RicOp {
  using V = Ric<Acc, M>;
  static constexpr int MM = M * M;
  const S* d;
  const S* ps;
  const S* qs;
  const S* as;
  S* out;
  long long n;

  __device__ V load(long long k, int) const {
    Acc p[M], q[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      p[i] = Acc(ps[i * n + k]);
      q[i] = Acc(qs[i * n + k]);
    }
    const Acc inv_d = Acc(1) / Acc(d[k]);
    V x;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        x.v[i * M + j] = Acc(as[(i * M + j) * n + k]) - q[i] * p[j] * inv_d;
        x.v[MM + i * M + j] = q[i] * q[j] * inv_d;
        x.v[2 * MM + i * M + j] = -(p[i] * p[j]) * inv_d;
      }
    return x;
  }

  __device__ void store(long long k, int, const V& x) const {
#pragma unroll
    for (int c = 0; c < MM; ++c) out[c * n + k] = S(x.v[MM + c]);
  }
};

template <typename S, int M1, int M2>
struct CplOp {
  using V = Cpl<Acc, M1, M2>;
  const S* A;
  const S* B;
  const S* C;
  S* out;
  long long n;

  __device__ V load(long long k, int) const {
    V x;
#pragma unroll
    for (int c = 0; c < M1 * M1; ++c) x.v[c] = Acc(A[c * n + k]);
#pragma unroll
    for (int c = 0; c < M2 * M2; ++c) x.v[V::OB + c] = Acc(B[c * n + k]);
#pragma unroll
    for (int c = 0; c < M1 * M2; ++c) x.v[V::OC + c] = Acc(C[c * n + k]);
    return x;
  }

  __device__ void store(long long k, int, const V& x) const {
#pragma unroll
    for (int c = 0; c < M1 * M2; ++c) out[c * n + k] = S(x.v[V::OC + c]);
  }
};

// ------------------------------------------------------------------- kernels

__device__ __forceinline__ long long element(long long pos, long long n, int reverse) {
  return reverse ? n - 1 - pos : pos;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
chunk_pass(Op op, long long n, int reverse, Acc* local, Acc* block) {
  using V = typename Op::V;
  Acc* sm = reinterpret_cast<Acc*>(qsl_smem);
  const int col = blockIdx.y;
  const long long nb = gridDim.x;
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  V acc = V::identity();
  for (int j = 0; j < kChunk; ++j) {
    const long long pos = gt * kChunk + j;
    if (pos >= n) break;
    acc = V::combine(acc, op.load(element(pos, n, reverse), col));
  }
  const V incl = block_inclusive_scan<V>(acc, sm);
  store(local + col * nb * kThreads * V::S, gt, block_exclusive<V>(sm));
  if (threadIdx.x == kThreads - 1) store(block + col * nb * V::S, blockIdx.x, incl);
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
finish_pass(Op op, long long n, int reverse, int inclusive, const Acc* local,
            const Acc* block) {
  using V = typename Op::V;
  const int col = blockIdx.y;
  const long long nb = gridDim.x;
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  V pre = V::combine(load<V>(block + col * nb * V::S, blockIdx.x),
                     load<V>(local + col * nb * kThreads * V::S, gt));
  for (int j = 0; j < kChunk; ++j) {
    const long long pos = gt * kChunk + j;
    if (pos >= n) break;
    const long long k = element(pos, n, reverse);
    const V x = op.load(k, col);
    if (!inclusive) op.store(k, col, pre);
    pre = V::combine(pre, x);
    if (inclusive) op.store(k, col, pre);
  }
}

// ------------------------------------------------------------------- host side

int monoid_size(int kind, int m) {
  switch (kind) {
    case kAff: return m * m + m;
    case kCong: return 2 * m * m;
    case kRic: return 3 * m * m;
    case kCpl: return 3 * m * m;
    default: return -1;
  }
}

// Workspace, in elements of Acc: per column, every thread's in-block prefix
// and every block's total.
long long workspace_elems(int kind, int m, long long n, int r) {
  const int s = monoid_size(kind, m);
  if (s < 0 || m < 1 || m > 4 || n < 1 || r < 1) return -1;
  const long long nb = num_blocks(n);
  return (long long)r * (nb * kThreads + nb) * s;
}

template <class Op>
cudaError_t run(const Op& op, long long n, int r, int reverse, int inclusive,
                Acc* work, cudaStream_t s) {
  using V = typename Op::V;
  const long long nb = num_blocks(n);
  Acc* local = work;
  Acc* block = work + (long long)r * nb * kThreads * V::S;
  const dim3 grid((unsigned)nb, (unsigned)r);
  const int st = scan_threads<V, Acc>();
  chunk_pass<Op><<<grid, kThreads, kThreads * V::S * sizeof(Acc), s>>>(
      op, n, reverse, local, block);
  scan_totals<V, Acc><<<dim3(1, (unsigned)r), st, st * V::S * sizeof(Acc), s>>>(
      (int)nb, block);
  finish_pass<Op><<<grid, kThreads, 0, s>>>(op, n, reverse, inclusive, local, block);
  return cudaGetLastError();
}

template <typename S, int M>
cudaError_t dispatch(int kind, long long n, int r, int reverse, int inclusive,
                     const S* x0, const S* x1, const S* x2, const S* x3, S* out,
                     Acc* work, cudaStream_t s) {
  switch (kind) {
    case kAff:
      return run(AffOp<S, M>{x0, x1, out, n, r}, n, r, reverse, inclusive, work, s);
    case kCong:
      return run(CongOp<S, M>{x0, x1, out, n}, n, 1, reverse, inclusive, work, s);
    case kRic:
      return run(RicOp<S, M>{x0, x1, x2, x3, out, n}, n, 1, reverse, inclusive, work, s);
    default:
      return run(CplOp<S, M, M>{x0, x1, x2, out, n}, n, 1, reverse, inclusive, work, s);
  }
}

template <typename S>
int scan(int kind, int m, long long n, int r, int reverse, int inclusive,
         const S* x0, const S* x1, const S* x2, const S* x3, S* out, Acc* work,
         long long work_elems, void* stream) {
  const long long need = workspace_elems(kind, m, n, r);
  if (need < 0 || work_elems < need || num_blocks(n) > 0x7fffffffLL ||
      r > 65535 || (kind != kAff && r != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)dispatch<S, 1>(kind, n, r, reverse, inclusive, x0, x1, x2, x3, out, work, s);
    case 2: return (int)dispatch<S, 2>(kind, n, r, reverse, inclusive, x0, x1, x2, x3, out, work, s);
    case 3: return (int)dispatch<S, 3>(kind, n, r, reverse, inclusive, x0, x1, x2, x3, out, work, s);
    default: return (int)dispatch<S, 4>(kind, n, r, reverse, inclusive, x0, x1, x2, x3, out, work, s);
  }
}

}  // namespace

extern "C" {

// Workspace a scan needs, in float64 elements; -1 for an unsupported kind
// or m. kind: 0 affine, 1 congruence, 2 Riccati, 3 coupling (m1 = m2 = m).
long long qss_workspace_elems(int kind, int m, long long n, int r) {
  return workspace_elems(kind, m, n, r);
}

// One scan into out. Operands by kind: affine (A, B), congruence (A, B),
// Riccati (d, ps, qs, as), coupling (A, B, C); unused pointers are null.
// r is the affine scan's number of columns (1 for the other kinds).
// Returns a cudaError_t code: nonzero if an argument is refused or a
// launch failed.
int qss_scan_f32(int kind, int m, long long n, int r, int reverse, int inclusive,
                 const float* x0, const float* x1, const float* x2,
                 const float* x3, float* out, double* work, long long work_elems,
                 void* stream) {
  return scan<float>(kind, m, n, r, reverse, inclusive, x0, x1, x2, x3, out,
                     work, work_elems, stream);
}

int qss_scan_f64(int kind, int m, long long n, int r, int reverse, int inclusive,
                 const double* x0, const double* x1, const double* x2,
                 const double* x3, double* out, double* work,
                 long long work_elems, void* stream) {
  return scan<double>(kind, m, n, r, reverse, inclusive, x0, x1, x2, x3, out,
                      work, work_elems, stream);
}

const char* qss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
