// Quasiseparable GP log-likelihood terms on Hopper (sm_90a): kernels B1 and
// B1r.
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_loglik.py:
// _loglik_kernel (line 86), launched by _call_kernel (line 275): with
// residuals=False as B1 (entries qsl_loglik_*), with residuals=True (from
// _fused_fwd, line 409) as B1r (entries qsl_loglik_res_*). For
// K = diag(d) + tril(p, q, a) + tril(p, q, a)^T with an m x m state it
// returns (quad, logdet) = (sum alpha^2, sum log c):
// the Riccati covariance flow F, the Cholesky emissions
// c = sqrt(d - p^T F p) and w = (q - a F p) / c, the whitening affine scan
// e with A = a - (w / c) p^T and B = (w / c) y, and alpha = (y - p^T e) / c.
// B1r also writes, for each element k, the residuals that the backward
// kernel (quasisep_loglik_bwd.cu) reads: the exclusive Riccati state F_k
// (m*m, n), the exclusive whitening state e_k (m, n) and 1/c_k (n), in the
// operands' type.
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
// 11.9 us at 3.35 TB/s. B1r writes (m*m + m + 1) values per element more:
// 68 MB and 20.3 us. The sequential algorithm's arithmetic, about 100
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
//                   re-runs its chunk for alpha and log c (B1r: and writes
//                   each element's F, e and 1/c), and the block writes its
//                   partial sums.
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

#include "quasisep_common.cuh"

namespace {

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

// kRes: also write each element's residuals F_k, e_k and 1/c_k (B1r).
template <typename S, int M, bool kRes>
__global__ void __launch_bounds__(kThreads)
finish_chunk(long long n, const S* d, const S* ps, const S* qs, const S* as,
             const S* y, const Acc* f_start, const Acc* aff_local,
             const Acc* aff_block, Acc* partials, S* Fs, S* es, S* ics) {
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
    if constexpr (kRes) {
#pragma unroll
      for (int r = 0; r < MM; ++r) Fs[r * n + k] = S(F[r]);
#pragma unroll
      for (int i = 0; i < M; ++i) es[i * n + k] = S(e[i]);
      ics[k] = S(T(1) / c);
    }
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

// Fs, es, ics: B1r's residual outputs, or null for B1.
template <typename S, int M>
cudaError_t run(long long n, const S* d, const S* ps, const S* qs,
                const S* as, const S* y, S* out, S* Fs, S* es, S* ics,
                Acc* work, cudaStream_t s) {
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
  if (Fs)
    finish_chunk<S, M, true><<<nb, kThreads, 2 * kThreads * sizeof(T), s>>>(
        n, d, ps, qs, as, y, f_start, aff_local, aff_block, partials, Fs, es,
        ics);
  else
    finish_chunk<S, M, false><<<nb, kThreads, 2 * kThreads * sizeof(T), s>>>(
        n, d, ps, qs, as, y, f_start, aff_local, aff_block, partials, Fs, es,
        ics);
  reduce_partials<S><<<1, kScanThreads, 2 * kScanThreads * sizeof(T), s>>>(
      nb, partials, out);
  return cudaGetLastError();
}

template <typename S>
int loglik(int m, long long n, const S* d, const S* ps, const S* qs,
           const S* as, const S* y, S* out, S* Fs, S* es, S* ics, Acc* work,
           long long work_elems, void* stream) {
  if (n < 1 || num_blocks(n) > 0x7fffffffLL || workspace_elems(m, n) < 0 ||
      work_elems < workspace_elems(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)run<S, 1>(n, d, ps, qs, as, y, out, Fs, es, ics, work, s);
    case 2: return (int)run<S, 2>(n, d, ps, qs, as, y, out, Fs, es, ics, work, s);
    case 3: return (int)run<S, 3>(n, d, ps, qs, as, y, out, Fs, es, ics, work, s);
    default: return (int)run<S, 4>(n, d, ps, qs, as, y, out, Fs, es, ics, work, s);
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
  return loglik<float>(m, n, d, ps, qs, as, y, out, nullptr, nullptr, nullptr,
                       work, work_elems, stream);
}

int qsl_loglik_f64(int m, int n, const double* d, const double* ps,
                   const double* qs, const double* as, const double* y,
                   double* out, double* work, long long work_elems,
                   void* stream) {
  return loglik<double>(m, n, d, ps, qs, as, y, out, nullptr, nullptr, nullptr,
                        work, work_elems, stream);
}

// B1r: (quad, logdet) as above, and the residuals F (m*m, n), e (m, n) and
// 1/c (n), in the operands' type. The same workspace as B1.
int qsl_loglik_res_f32(int m, int n, const float* d, const float* ps,
                       const float* qs, const float* as, const float* y,
                       float* out, float* Fs, float* es, float* ics,
                       double* work, long long work_elems, void* stream) {
  return loglik<float>(m, n, d, ps, qs, as, y, out, Fs, es, ics, work,
                       work_elems, stream);
}

int qsl_loglik_res_f64(int m, int n, const double* d, const double* ps,
                       const double* qs, const double* as, const double* y,
                       double* out, double* Fs, double* es, double* ics,
                       double* work, long long work_elems, void* stream) {
  return loglik<double>(m, n, d, ps, qs, as, y, out, Fs, es, ics, work,
                        work_elems, stream);
}

const char* qsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
