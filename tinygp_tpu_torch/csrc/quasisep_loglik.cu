// Quasiseparable GP log-likelihood terms on Hopper (sm_90a).
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_loglik.py:
// _loglik_kernel (line 86), launched by _call_kernel (line 275) with
// residuals=False. For K = diag(d) + tril(p, q, a) + tril(p, q, a)^T with
// an m x m state it returns (quad, logdet) = (sum alpha^2, sum log c):
// the Riccati covariance flow F, the Cholesky emissions
// c = sqrt(d - p^T F p) and w = (q - a F p) / c, the whitening affine scan
// e with A = a - (w / c) p^T and B = (w / c) y, and alpha = (y - p^T e) / c.
//
// Operands are stacked as in the JAX package: d, y of length n; ps, qs of
// shape (m, n); as of shape (m*m, n), row i*m+j holding a[i, j]; all
// row-major and contiguous, in float32 or float64.
//
// Precision. Whatever the operands' type, every scan runs in float64
// (`Acc`), and so does the workspace. Composing the Riccati Moebius maps of
// long spans in float32 loses the state: on the Matern-3/2 benchmark at
// n = 1e6 (sorted uniform points on [0, 10], diag 0.1), a float32 build of
// this kernel started its chunks from an F far from the float64 flow and
// returned NaN. The card's float64 rate costs little here, since the
// kernel is bound by its passes and not by its arithmetic.
//
// What bounds it: bytes. The function must read (m*m + 2m + 2) values per
// element once and writes two scalars: 40 MB at n = 1e6, m = 2 in float32,
// 11.9 us at 3.35 TB/s. The sequential algorithm's arithmetic, about 100
// flops per element for m = 2, would take 1.4 us at the float32 peak.
//
// Design. The TPU kernel carries the scan state from one grid step to the
// next in VMEM, which relies on the TPU grid running in order. CUDA blocks
// run in no order, so this is a chunked multi-pass scan, with the two
// dependent scans (the whitening elements need F) as two global phases:
//
//   1. ric_chunk:   each thread folds its chunk of kChunk consecutive
//                   elements into one Riccati Moebius triple (A, F, G)
//                   (the combine of scan.py:566-590); a Kogge-Stone scan in
//                   shared memory gives each thread its in-block exclusive
//                   prefix, and the last thread writes the block total.
//   2. scan_totals: one block scans the block totals (exclusive, in place).
//   3. aff_chunk:   each thread composes its prefix, whose F component is
//                   the state at its chunk's start (the flow starts at
//                   F = 0), stores that F, and re-runs its chunk with the
//                   SEQUENTIAL recurrence F' = a F a^T + u u^T / c2
//                   (scan.py:962-968), forming the affine elements and
//                   folding them into a chunk total; block scan as in 1.
//   4. scan_totals: the affine block totals.
//   5. finish:      each thread starts from its stored F and its e prefix,
//                   re-runs its chunk for alpha and log c, and the block
//                   writes its partial sums.
//   6. reduce:      one block sums the partials in a fixed order, so the
//                   result is deterministic (no float atomics).
//
// Since the chunks run the sequential recurrence while the prefixes compose
// Moebius maps, agreement with the plain version checks the algorithm and
// not only the code. The ragged end is masked in the kernel; nothing is
// padded. The cost of this design against the bound: the inputs are read
// three times (passes 1, 3 and 5) with strided per-thread loads, and each
// call is six launches. Coalescing through shared memory and a single pass
// with a decoupled look-back are later work.

#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char qsl_smem[];

namespace {

constexpr int kThreads = 64;  // threads per block of the chunk passes
constexpr int kChunk = 8;     // consecutive elements per thread
constexpr int kScanThreads = 256;
constexpr int kSharedLimit = 48 * 1024;

using Acc = double;  // the arithmetic type of every scan (see Precision)

// ---------------------------------------------------------------- m x m algebra

template <typename T, int M>
__device__ __forceinline__ void mm(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = a[i * M] * b[j];
#pragma unroll
      for (int l = 1; l < M; ++l) acc += a[i * M + l] * b[l * M + j];
      out[i * M + j] = acc;
    }
}

// a @ b^T
template <typename T, int M>
__device__ __forceinline__ void mm_nt(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = a[i * M] * b[j * M];
#pragma unroll
      for (int l = 1; l < M; ++l) acc += a[i * M + l] * b[j * M + l];
      out[i * M + j] = acc;
    }
}

// a^T @ b
template <typename T, int M>
__device__ __forceinline__ void mm_tn(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = a[i] * b[j];
#pragma unroll
      for (int l = 1; l < M; ++l) acc += a[l * M + i] * b[l * M + j];
      out[i * M + j] = acc;
    }
}

template <typename T>
__device__ __forceinline__ void inv2(const T* x, T* out) {
  const T idet = T(1) / (x[0] * x[3] - x[1] * x[2]);
  out[0] = x[3] * idet;
  out[1] = -x[1] * idet;
  out[2] = -x[2] * idet;
  out[3] = x[0] * idet;
}

template <typename T>
__device__ __forceinline__ void mul2(const T* x, const T* y, T* out) {
  out[0] = x[0] * y[0] + x[1] * y[2];
  out[1] = x[0] * y[1] + x[1] * y[3];
  out[2] = x[2] * y[0] + x[3] * y[2];
  out[3] = x[2] * y[1] + x[3] * y[3];
}

// Closed-form inverses: adjugates for m <= 3 and the block-Schur form of
// scan.py:_inv4_components for m = 4. The scan merges invert I + F G,
// which is near the identity, so no pivoting is needed.
template <typename T, int M>
__device__ __forceinline__ void inverse(const T* x, T* out) {
  if constexpr (M == 1) {
    out[0] = T(1) / x[0];
  } else if constexpr (M == 2) {
    inv2(x, out);
  } else if constexpr (M == 3) {
    const T a = x[0], b = x[1], c = x[2], d = x[3], e = x[4], f = x[5],
            g = x[6], h = x[7], i = x[8];
    const T A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
    const T D = -(b * i - c * h), E = a * i - c * g, F = -(a * h - b * g);
    const T G = b * f - c * e, H = -(a * f - c * d), I = a * e - b * d;
    const T idet = T(1) / (a * A + b * B + c * C);
    out[0] = A * idet; out[1] = D * idet; out[2] = G * idet;
    out[3] = B * idet; out[4] = E * idet; out[5] = H * idet;
    out[6] = C * idet; out[7] = F * idet; out[8] = I * idet;
  } else {
    static_assert(M == 4, "m must be 1..4");
    const T p[4] = {x[0], x[1], x[4], x[5]};
    const T q[4] = {x[2], x[3], x[6], x[7]};
    const T r[4] = {x[8], x[9], x[12], x[13]};
    const T s[4] = {x[10], x[11], x[14], x[15]};
    T pinv[4], rpinv[4], tmp[4], t[4], tinv[4], pinvq[4], tl[4], tr[4];
    inv2(p, pinv);
    mul2(r, pinv, rpinv);
    mul2(rpinv, q, tmp);
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = s[k] - tmp[k];
    inv2(t, tinv);
    mul2(pinv, q, pinvq);
    mul2(tinv, rpinv, tl);  // T^-1 R P^-1
    mul2(pinvq, tinv, tr);  // P^-1 Q T^-1
    mul2(tr, rpinv, tmp);
    out[0] = pinv[0] + tmp[0]; out[1] = pinv[1] + tmp[1];
    out[4] = pinv[2] + tmp[2]; out[5] = pinv[3] + tmp[3];
    out[2] = -tr[0]; out[3] = -tr[1]; out[6] = -tr[2]; out[7] = -tr[3];
    out[8] = -tl[0]; out[9] = -tl[1]; out[12] = -tl[2]; out[13] = -tl[3];
    out[10] = tinv[0]; out[11] = tinv[1]; out[14] = tinv[2]; out[15] = tinv[3];
  }
}

// -------------------------------------------------------------------- monoids

// The Riccati flow as a Moebius map (A, F, G), flattened [A | F | G].
template <typename T, int M>
struct Ric {
  static constexpr int MM = M * M;
  static constexpr int S = 3 * MM;
  T v[S];

  __device__ static Ric identity() {
    Ric r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < MM && c % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // M = I + F_e G_l;  A = A_l M^-1 A_e;  F = F_l + A_l M^-1 F_e A_l^T;
  // G = G_e + A_e^T M^-T G_l A_e.
  __device__ static Ric combine(const Ric& e, const Ric& l) {
    const T* Ae = e.v; const T* Fe = e.v + MM; const T* Ge = e.v + 2 * MM;
    const T* Al = l.v; const T* Fl = l.v + MM; const T* Gl = l.v + 2 * MM;
    T mat[MM], minv[MM], t1[MM], t2[MM];
    mm<T, M>(Fe, Gl, mat);
#pragma unroll
    for (int i = 0; i < M; ++i) mat[i * (M + 1)] += T(1);
    inverse<T, M>(mat, minv);
    Ric out;
    mm<T, M>(minv, Ae, t1);
    mm<T, M>(Al, t1, out.v);
    mm<T, M>(minv, Fe, t1);
    mm<T, M>(Al, t1, t2);
    mm_nt<T, M>(t2, Al, t1);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[MM + c] = Fl[c] + t1[c];
    mm_tn<T, M>(minv, Gl, t1);
    mm<T, M>(t1, Ae, t2);
    mm_tn<T, M>(Ae, t2, t1);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[2 * MM + c] = Ge[c] + t1[c];
    return out;
  }
};

// The affine recurrence g' = A g + B, flattened [A | B].
template <typename T, int M>
struct Aff {
  static constexpr int MM = M * M;
  static constexpr int S = MM + M;
  T v[S];

  __device__ static Aff identity() {
    Aff r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < MM && c % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // (A_l A_e, A_l B_e + B_l)
  __device__ static Aff combine(const Aff& e, const Aff& l) {
    Aff out;
    mm<T, M>(l.v, e.v, out.v);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = l.v[MM + i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += l.v[i * M + j] * e.v[MM + j];
      out.v[MM + i] = acc;
    }
    return out;
  }
};

template <class V, typename T>
__device__ __forceinline__ V load(const T* src, long long idx) {
  V x;
#pragma unroll
  for (int c = 0; c < V::S; ++c) x.v[c] = src[idx * V::S + c];
  return x;
}

template <class V, typename T>
__device__ __forceinline__ void store(T* dst, long long idx, const V& x) {
#pragma unroll
  for (int c = 0; c < V::S; ++c) dst[idx * V::S + c] = x.v[c];
}

// Shared memory holds one value per thread and component, component-major
// (sm[c * nt + t]) so that neighbouring threads hit neighbouring banks.
template <class V, typename T>
__device__ __forceinline__ V sm_load(const T* sm, int t, int nt) {
  V x;
#pragma unroll
  for (int c = 0; c < V::S; ++c) x.v[c] = sm[c * nt + t];
  return x;
}

template <class V, typename T>
__device__ __forceinline__ void sm_store(T* sm, int t, int nt, const V& x) {
#pragma unroll
  for (int c = 0; c < V::S; ++c) sm[c * nt + t] = x.v[c];
}

// Kogge-Stone inclusive scan over the block's threads. On return the
// shared array holds every thread's inclusive value.
template <class V, typename T>
__device__ V block_inclusive_scan(V x, T* sm) {
  const int t = threadIdx.x, nt = blockDim.x;
  sm_store<V>(sm, t, nt, x);
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    V y = x;
    if (t >= off) y = V::combine(sm_load<V>(sm, t - off, nt), x);
    __syncthreads();
    if (t >= off) {
      x = y;
      sm_store<V>(sm, t, nt, x);
    }
    __syncthreads();
  }
  return x;
}

template <class V, typename T>
__device__ __forceinline__ V block_exclusive(const T* sm) {
  const int t = threadIdx.x;
  return t == 0 ? V::identity() : sm_load<V>(sm, t - 1, blockDim.x);
}

// ------------------------------------------------------------ per-element math

// One element's operands, loaded from the storage type S into T.
template <typename T, int M>
struct Elem {
  T d, y, p[M], q[M], a[M * M];

  template <typename S>
  __device__ __forceinline__ Elem(const S* d_, const S* ps, const S* qs,
                                  const S* as, const S* y_, long long k,
                                  long long n) {
    d = T(d_[k]);
    y = y_ ? T(y_[k]) : T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      p[i] = T(ps[i * n + k]);
      q[i] = T(qs[i * n + k]);
    }
#pragma unroll
    for (int c = 0; c < M * M; ++c) a[c] = T(as[c * n + k]);
  }

  // The step's Moebius map: A = a - q p^T / d, F = q q^T / d,
  // G = -p p^T / d.
  __device__ __forceinline__ Ric<T, M> moebius() const {
    Ric<T, M> r;
    const T inv_d = T(1) / d;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        r.v[i * M + j] = a[i * M + j] - q[i] * p[j] * inv_d;
        r.v[M * M + i * M + j] = q[i] * q[j] * inv_d;
        r.v[2 * M * M + i * M + j] = -(p[i] * p[j]) * inv_d;
      }
    return r;
  }

  // Cholesky emission from the state F before this step:
  // c2 = d - p^T F p and u = q - a F p (so w = u / c).
  __device__ __forceinline__ T emit(const T* F, T* u) const {
    T Fp[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = F[i * M] * p[0];
#pragma unroll
      for (int j = 1; j < M; ++j) acc += F[i * M + j] * p[j];
      Fp[i] = acc;
    }
    T c2 = d;
#pragma unroll
    for (int i = 0; i < M; ++i) c2 -= p[i] * Fp[i];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = q[i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc -= a[i * M + j] * Fp[j];
      u[i] = acc;
    }
    return c2;
  }

  // The whitening step's affine element: wd = w / c = u / c2,
  // A = a - wd p^T, B = wd y.
  __device__ __forceinline__ Aff<T, M> affine(const T* u, T c2) const {
    Aff<T, M> r;
    const T inv_c2 = T(1) / c2;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T wd = u[i] * inv_c2;
#pragma unroll
      for (int j = 0; j < M; ++j) r.v[i * M + j] = a[i * M + j] - wd * p[j];
      r.v[M * M + i] = wd * y;
    }
    return r;
  }

  // The sequential Riccati step F <- a F a^T + u u^T / c2.
  __device__ __forceinline__ void advance(T* F, const T* u, T c2) const {
    T aF[M * M], next[M * M];
    mm<T, M>(a, F, aF);
    mm_nt<T, M>(aF, a, next);
    const T inv_c2 = T(1) / c2;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) F[i * M + j] = next[i * M + j] + u[i] * u[j] * inv_c2;
  }
};

// ------------------------------------------------------------------- kernels

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
ric_chunk(long long n, const S* d, const S* ps, const S* qs, const S* as,
          Acc* ric_local, Acc* ric_block) {
  using T = Acc;
  using R = Ric<T, M>;
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long k0 = gt * kChunk;
  R acc = R::identity();
  for (int j = 0; j < kChunk; ++j) {
    const long long k = k0 + j;
    if (k >= n) break;
    acc = R::combine(acc, Elem<T, M>(d, ps, qs, as, (const S*)nullptr, k, n).moebius());
  }
  const R incl = block_inclusive_scan<R>(acc, sm);
  store(ric_local, gt, block_exclusive<R>(sm));
  if (threadIdx.x == kThreads - 1) store(ric_block, blockIdx.x, incl);
}

// Exclusive scan of `nb` block totals, in place, by one block.
template <class V, typename T>
__global__ void scan_totals(int nb, T* tot) {
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const int t = threadIdx.x, nt = blockDim.x;
  const int per = (nb + nt - 1) / nt;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  V acc = V::identity();
  for (int i = lo; i < hi; ++i) acc = V::combine(acc, load<V>(tot, i));
  block_inclusive_scan<V>(acc, sm);
  V pre = block_exclusive<V>(sm);
  for (int i = lo; i < hi; ++i) {
    const V x = load<V>(tot, i);
    store(tot, i, pre);
    pre = V::combine(pre, x);
  }
}

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
aff_chunk(long long n, const S* d, const S* ps, const S* qs, const S* as,
          const S* y, const Acc* ric_local, const Acc* ric_block, Acc* f_start,
          Acc* aff_local, Acc* aff_block) {
  using T = Acc;
  using R = Ric<T, M>;
  using A = Aff<T, M>;
  constexpr int MM = M * M;
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long k0 = gt * kChunk;
  // The state at the chunk's start is the F of the composed prefix.
  const R pre = R::combine(load<R>(ric_block, blockIdx.x), load<R>(ric_local, gt));
  T F[MM];
#pragma unroll
  for (int c = 0; c < MM; ++c) {
    F[c] = pre.v[MM + c];
    f_start[gt * MM + c] = F[c];
  }
  A acc = A::identity();
  for (int j = 0; j < kChunk; ++j) {
    const long long k = k0 + j;
    if (k >= n) break;
    const Elem<T, M> el(d, ps, qs, as, y, k, n);
    T u[M];
    const T c2 = el.emit(F, u);
    acc = A::combine(acc, el.affine(u, c2));
    el.advance(F, u, c2);
  }
  const A incl = block_inclusive_scan<A>(acc, sm);
  store(aff_local, gt, block_exclusive<A>(sm));
  if (threadIdx.x == kThreads - 1) store(aff_block, blockIdx.x, incl);
}

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
finish_chunk(long long n, const S* d, const S* ps, const S* qs, const S* as,
             const S* y, const Acc* f_start, const Acc* aff_local,
             const Acc* aff_block, Acc* partials) {
  using T = Acc;
  using A = Aff<T, M>;
  constexpr int MM = M * M;
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long k0 = gt * kChunk;
  T F[MM];
#pragma unroll
  for (int c = 0; c < MM; ++c) F[c] = f_start[gt * MM + c];
  // The whitening state at the chunk's start: the flow starts at e = 0,
  // so the block prefix's B is the state at the block's start.
  const A blk = load<A>(aff_block, blockIdx.x);
  const A loc = load<A>(aff_local, gt);
  T e[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = loc.v[MM + i];
#pragma unroll
    for (int j = 0; j < M; ++j) acc += loc.v[i * M + j] * blk.v[MM + j];
    e[i] = acc;
  }
  T quad = T(0), logdet = T(0);
  for (int j = 0; j < kChunk; ++j) {
    const long long k = k0 + j;
    if (k >= n) break;
    const Elem<T, M> el(d, ps, qs, as, y, k, n);
    T u[M];
    const T c2 = el.emit(F, u);
    const T c = sqrt(c2);
    T pe = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) pe += el.p[i] * e[i];
    const T alpha = (el.y - pe) / c;
    quad += alpha * alpha;
    logdet += log(c);
    const A step = el.affine(u, c2);
    T next[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = step.v[MM + i];
#pragma unroll
      for (int l = 0; l < M; ++l) acc += step.v[i * M + l] * e[l];
      next[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) e[i] = next[i];
    el.advance(F, u, c2);
  }
  // Tree reduction of the block's two partial sums.
  const int t = threadIdx.x;
  sm[t] = quad;
  sm[kThreads + t] = logdet;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      sm[t] += sm[t + s];
      sm[kThreads + t] += sm[kThreads + t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    partials[2 * (long long)blockIdx.x] = sm[0];
    partials[2 * (long long)blockIdx.x + 1] = sm[kThreads];
  }
}

template <typename S>
__global__ void reduce_partials(int nb, const Acc* partials, S* out) {
  using T = Acc;
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const int t = threadIdx.x;
  T quad = T(0), logdet = T(0);
  for (int i = t; i < nb; i += kScanThreads) {
    quad += partials[2 * (long long)i];
    logdet += partials[2 * (long long)i + 1];
  }
  sm[t] = quad;
  sm[kScanThreads + t] = logdet;
  __syncthreads();
  for (int s = kScanThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      sm[t] += sm[t + s];
      sm[kScanThreads + t] += sm[kScanThreads + t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = S(sm[0]);
    out[1] = S(sm[kScanThreads]);
  }
}

// ------------------------------------------------------------------- host side

long long num_blocks(long long n) {
  return (n + (long long)kThreads * kChunk - 1) / ((long long)kThreads * kChunk);
}

// Workspace layout, in elements of Acc.
template <int M>
struct Layout {
  static constexpr int MM = M * M;
  long long nb, nt, ric_local, ric_block, f_start, aff_local, aff_block,
      partials, total;
  explicit Layout(long long n) {
    nb = num_blocks(n);
    nt = nb * kThreads;
    ric_local = 0;
    ric_block = ric_local + nt * 3 * MM;
    f_start = ric_block + nb * 3 * MM;
    aff_local = f_start + nt * MM;
    aff_block = aff_local + nt * (MM + M);
    partials = aff_block + nb * (MM + M);
    total = partials + nb * 2;
  }
};

long long workspace_elems(int m, long long n) {
  switch (m) {
    case 1: return Layout<1>(n).total;
    case 2: return Layout<2>(n).total;
    case 3: return Layout<3>(n).total;
    case 4: return Layout<4>(n).total;
    default: return -1;
  }
}

// Threads of a single-block scan: as many as fit the default shared limit.
template <class V, typename T>
int scan_threads() {
  int nt = kScanThreads;
  while (nt > 32 && (long long)nt * V::S * sizeof(T) > kSharedLimit) nt /= 2;
  return nt;
}

template <typename S, int M>
cudaError_t run(long long n, const S* d, const S* ps, const S* qs,
                const S* as, const S* y, S* out, Acc* work, cudaStream_t s) {
  using T = Acc;
  using R = Ric<T, M>;
  using A = Aff<T, M>;
  const Layout<M> L(n);
  const int nb = (int)L.nb;
  T* ric_local = work + L.ric_local;
  T* ric_block = work + L.ric_block;
  T* f_start = work + L.f_start;
  T* aff_local = work + L.aff_local;
  T* aff_block = work + L.aff_block;
  T* partials = work + L.partials;
  const int rt = scan_threads<R, T>(), at = scan_threads<A, T>();

  ric_chunk<S, M><<<nb, kThreads, kThreads * R::S * sizeof(T), s>>>(
      n, d, ps, qs, as, ric_local, ric_block);
  scan_totals<R, T><<<1, rt, rt * R::S * sizeof(T), s>>>(nb, ric_block);
  aff_chunk<S, M><<<nb, kThreads, kThreads * A::S * sizeof(T), s>>>(
      n, d, ps, qs, as, y, ric_local, ric_block, f_start, aff_local,
      aff_block);
  scan_totals<A, T><<<1, at, at * A::S * sizeof(T), s>>>(nb, aff_block);
  finish_chunk<S, M><<<nb, kThreads, 2 * kThreads * sizeof(T), s>>>(
      n, d, ps, qs, as, y, f_start, aff_local, aff_block, partials);
  reduce_partials<S><<<1, kScanThreads, 2 * kScanThreads * sizeof(T), s>>>(
      nb, partials, out);
  return cudaGetLastError();
}

template <typename S>
int loglik(int m, long long n, const S* d, const S* ps, const S* qs,
           const S* as, const S* y, S* out, Acc* work, long long work_elems,
           void* stream) {
  if (n < 1 || num_blocks(n) > 0x7fffffffLL || workspace_elems(m, n) < 0 ||
      work_elems < workspace_elems(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)run<S, 1>(n, d, ps, qs, as, y, out, work, s);
    case 2: return (int)run<S, 2>(n, d, ps, qs, as, y, out, work, s);
    case 3: return (int)run<S, 3>(n, d, ps, qs, as, y, out, work, s);
    default: return (int)run<S, 4>(n, d, ps, qs, as, y, out, work, s);
  }
}

}  // namespace

extern "C" {

// Workspace the launch needs, in float64 elements; -1 for an unsupported m.
long long qsl_workspace_elems(int m, int n) { return workspace_elems(m, n); }

// (quad, logdet) into out[0], out[1]. Returns a cudaError_t code: nonzero
// if an argument is refused or a launch failed.
int qsl_loglik_f32(int m, int n, const float* d, const float* ps,
                   const float* qs, const float* as, const float* y,
                   float* out, double* work, long long work_elems,
                   void* stream) {
  return loglik<float>(m, n, d, ps, qs, as, y, out, work, work_elems, stream);
}

int qsl_loglik_f64(int m, int n, const double* d, const double* ps,
                   const double* qs, const double* as, const double* y,
                   double* out, double* work, long long work_elems,
                   void* stream) {
  return loglik<double>(m, n, d, ps, qs, as, y, out, work, work_elems, stream);
}

const char* qsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
