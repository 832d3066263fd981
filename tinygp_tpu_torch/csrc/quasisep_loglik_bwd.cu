// Backward of the quasiseparable GP log-likelihood on Hopper (sm_90a):
// kernel B2.
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_loglik.py:
// _bwd_kernel (line 414), launched by _call_bwd_kernel (line 602). From the
// residuals that kernel B1r wrote (quasisep_loglik.cu: the exclusive
// Riccati state F_k, the exclusive whitening state e_k and ic_k = 1/c_k)
// and the cotangents qbar, lbar of (quad, logdet) = (sum alpha^2,
// sum log c), it returns the cotangents of (d, ps, qs, as, y).
//
// The math (pallas_loglik.py:452-599). Each element's emissions are
// recomputed from the residuals: Fp = F p, u = q - a Fp, wd = u ic^2, the
// whitening transition A = a - wd p^T, alpha = (y - p.e) ic,
// alphabar = 2 qbar alpha and ebar = -alphabar ic p. Two reverse exclusive
// scans follow, both with the transitions A^T (A equals the Riccati
// linearisation a~ of scan.py:_riccati_bwd_s):
//
//   the affine adjoint      lambda_k = A_k^T lambda_{k+1} + ebar_k,
//                           mu_k = lambda_{k+1};
//   the congruence adjoint  Fbar_k = A_k^T Fbar_{k+1} A_k + Ybar_k,
//                           Gbar_k = Fbar_{k+1},
//
// where the congruence load Ybar_k = Fpbar_k p_k^T needs mu_k (through
// wdbar = mu (y - p.e)). The outputs need mu_k and Gbar_k; they are
// elementwise in them (BwdElem::glue and out_chunk).
//
// Operands are stacked as in the forward kernel: y, ic of length n; ps, qs,
// e of shape (m, n); as, F of shape (m*m, n); all contiguous, in float32 or
// float64. qbar and lbar are single values in device memory, read by the
// kernels, so nothing waits on the host. Every scan runs in float64, as in
// the forward kernel; the outputs are stored in the operands' type.
//
// What bounds it: bytes. The function reads (2m^2 + 3m + 2) values per
// element and writes (m^2 + 2m + 2): (3m^2 + 5m + 4) values, 104 MB at
// n = 1e6 with m = 2 in float32, 31.0 us at 3.35 TB/s.
//
// Design. CUDA blocks run in no order, so, like the forward kernel, this
// is a chunked multi-pass scan. A suffix scan is a prefix scan of the
// mirrored sequence: thread t owns the mirrored positions
// j = t*kChunk .. t*kChunk + kChunk - 1, i.e. the elements k = n-1-j in
// descending order, so the forward monoids, the in-block Kogge-Stone scan
// and the block-totals scan serve unchanged. The congruence loads need mu,
// the outputs need mu and Gbar, so there are five passes:
//
//   1. adj_chunk:   each thread folds its chunk's affine-adjoint elements
//                   (A^T, ebar), recomputed elementwise from (F, e, ic),
//                   into a chunk total; in-block scan; block totals.
//   2. scan_totals: the affine block totals (exclusive, in place).
//   3. cong_chunk:  each thread composes its prefix, whose B component is
//                   mu at its chunk's start (lambda starts at 0), stores
//                   it, and re-runs its chunk sequentially to get each mu_k
//                   and form the congruence elements (A^T, Ybar); chunk
//                   totals and block scan as in 1.
//   4. scan_totals: the congruence block totals.
//   5. out_chunk:   each thread starts from its stored mu and its Gbar
//                   prefix, re-runs both recurrences over its chunk and
//                   writes the m^2 + 2m + 2 cotangents of each element.
//
// The ragged end is masked in the kernels; nothing is padded. The cost
// against the bound: the inputs are read three times with strided
// per-thread loads, five launches, float64 arithmetic, and for m = 4 more
// live values than registers.

#include "quasisep_common.cuh"

namespace {

// The congruence recurrence G' = T G T^T + B, flattened [T | B].
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

  // (T_l T_e, T_l B_e T_l^T + B_l)
  __device__ static Cong combine(const Cong& e, const Cong& l) {
    Cong out;
    T t1[MM], t2[MM];
    mm<T, M>(l.v, e.v, out.v);
    mm<T, M>(l.v, e.v + MM, t1);
    mm_nt<T, M>(t1, l.v, t2);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[MM + c] = t2[c] + l.v[MM + c];
    return out;
  }
};

// One element's residuals, loaded from the storage type S into T, and the
// forward emissions recomputed from them.
template <typename T, int M>
struct BwdElem {
  static constexpr int MM = M * M;
  T y, ic, ic2, r, alpha, alphabar;
  T p[M], a[MM], F[MM], e[M], Fp[M], u[M], wd[M];

  template <typename S>
  __device__ __forceinline__ BwdElem(const S* ps, const S* qs, const S* as,
                                     const S* y_, const S* Fs, const S* es,
                                     const S* ics, T qb, long long k,
                                     long long n) {
    T q[M];
    y = T(y_[k]);
    ic = T(ics[k]);
    ic2 = ic * ic;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      p[i] = T(ps[i * n + k]);
      q[i] = T(qs[i * n + k]);
      e[i] = T(es[i * n + k]);
    }
#pragma unroll
    for (int c = 0; c < MM; ++c) {
      a[c] = T(as[c * n + k]);
      F[c] = T(Fs[c * n + k]);
    }
    T pe = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += F[i * M + j] * p[j];
      Fp[i] = acc;
      pe += p[i] * e[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = q[i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc -= a[i * M + j] * Fp[j];
      u[i] = acc;
      wd[i] = acc * ic2;
    }
    r = y - pe;
    alpha = r * ic;
    alphabar = T(2) * qb * alpha;
  }

  // The transposed whitening transition A^T = (a - wd p^T)^T.
  __device__ __forceinline__ void transition_t(T* out) const {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) out[j * M + i] = a[i * M + j] - wd[i] * p[j];
  }

  // The affine-adjoint element (A^T, ebar), ebar = -alphabar ic p.
  __device__ __forceinline__ Aff<T, M> adjoint() const {
    Aff<T, M> x;
    transition_t(x.v);
#pragma unroll
    for (int i = 0; i < M; ++i) x.v[MM + i] = -(alphabar * ic) * p[i];
    return x;
  }

  // lambda <- A^T lambda + ebar, in place.
  __device__ __forceinline__ void adjoint_step(T* lam) const {
    T wl = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) wl += wd[i] * lam[i];
    T next[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = -(wl + alphabar * ic) * p[j];
#pragma unroll
      for (int i = 0; i < M; ++i) acc += a[i * M + j] * lam[i];
      next[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < M; ++j) lam[j] = next[j];
  }

  // The cotangent glue from mu: ubar, c2bar and Fpbar (the congruence load
  // is Ybar = Fpbar p^T). wdbar = mu y - Abar p with Abar = mu e^T, which
  // is mu (y - p.e).
  __device__ __forceinline__ void glue(const T* mu, T lb, T* ubar, T& c2bar,
                                       T* Fpbar) const {
    T uw = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T wdbar = mu[i] * r;
      ubar[i] = wdbar * ic2;
      uw += u[i] * wdbar;
    }
    const T icbar = -lb / ic + alphabar * alpha / ic + T(2) * ic * uw;
    c2bar = T(-0.5) * icbar * ic * ic2;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = -c2bar * p[j];
#pragma unroll
      for (int i = 0; i < M; ++i) acc -= a[i * M + j] * ubar[i];
      Fpbar[j] = acc;
    }
  }

  // The congruence element (A^T, Fpbar p^T).
  __device__ __forceinline__ Cong<T, M> congruence(const T* Fpbar) const {
    Cong<T, M> x;
    transition_t(x.v);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) x.v[MM + i * M + j] = Fpbar[i] * p[j];
    return x;
  }
};

// Element k of thread gt's mirrored chunk position jj, or -1 past the end.
__device__ __forceinline__ long long mirrored(long long n, long long gt, int jj) {
  const long long j = gt * kChunk + jj;
  return j < n ? n - 1 - j : -1;
}

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
adj_chunk(long long n, const S* ps, const S* qs, const S* as, const S* y,
          const S* Fs, const S* es, const S* ics, const S* qbar,
          Acc* aff_local, Acc* aff_block) {
  using T = Acc;
  using A = Aff<T, M>;
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const T qb = T(*qbar);
  A acc = A::identity();
  for (int jj = 0; jj < kChunk; ++jj) {
    const long long k = mirrored(n, gt, jj);
    if (k < 0) break;
    acc = A::combine(acc, BwdElem<T, M>(ps, qs, as, y, Fs, es, ics, qb, k, n).adjoint());
  }
  const A incl = block_inclusive_scan<A>(acc, sm);
  store(aff_local, gt, block_exclusive<A>(sm));
  if (threadIdx.x == kThreads - 1) store(aff_block, blockIdx.x, incl);
}

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
cong_chunk(long long n, const S* ps, const S* qs, const S* as, const S* y,
           const S* Fs, const S* es, const S* ics, const S* qbar,
           const S* lbar, const Acc* aff_local, const Acc* aff_block,
           Acc* mu_start, Acc* cong_local, Acc* cong_block) {
  using T = Acc;
  using A = Aff<T, M>;
  using C = Cong<T, M>;
  constexpr int MM = M * M;
  T* sm = reinterpret_cast<T*>(qsl_smem);
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const T qb = T(*qbar), lb = T(*lbar);
  // The adjoint state at the chunk's start: lambda starts at 0, so it is
  // the B component of the composed prefix.
  const A pre = A::combine(load<A>(aff_block, blockIdx.x), load<A>(aff_local, gt));
  T lam[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    lam[i] = pre.v[MM + i];
    mu_start[gt * M + i] = lam[i];
  }
  C acc = C::identity();
  for (int jj = 0; jj < kChunk; ++jj) {
    const long long k = mirrored(n, gt, jj);
    if (k < 0) break;
    const BwdElem<T, M> el(ps, qs, as, y, Fs, es, ics, qb, k, n);
    T ubar[M], c2bar, Fpbar[M];
    el.glue(lam, lb, ubar, c2bar, Fpbar);
    acc = C::combine(acc, el.congruence(Fpbar));
    el.adjoint_step(lam);
  }
  const C incl = block_inclusive_scan<C>(acc, sm);
  store(cong_local, gt, block_exclusive<C>(sm));
  if (threadIdx.x == kThreads - 1) store(cong_block, blockIdx.x, incl);
}

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
out_chunk(long long n, const S* ps, const S* qs, const S* as, const S* y,
          const S* Fs, const S* es, const S* ics, const S* qbar,
          const S* lbar, const Acc* mu_start, const Acc* cong_local,
          const Acc* cong_block, S* dbar, S* psbar, S* qsbar, S* asbar,
          S* ybar) {
  using T = Acc;
  using C = Cong<T, M>;
  constexpr int MM = M * M;
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gt * kChunk >= n) return;
  const T qb = T(*qbar), lb = T(*lbar);
  T lam[M], G[MM];
#pragma unroll
  for (int i = 0; i < M; ++i) lam[i] = mu_start[gt * M + i];
  // Gbar at the chunk's start: the adjoint flow starts at 0.
  const C pre = C::combine(load<C>(cong_block, blockIdx.x), load<C>(cong_local, gt));
#pragma unroll
  for (int c = 0; c < MM; ++c) G[c] = pre.v[MM + c];

  for (int jj = 0; jj < kChunk; ++jj) {
    const long long k = mirrored(n, gt, jj);
    if (k < 0) break;
    const BwdElem<T, M> el(ps, qs, as, y, Fs, es, ics, qb, k, n);
    T ubar[M], c2bar, Fpbar[M];
    el.glue(lam, lb, ubar, c2bar, Fpbar);  // lam is mu_k here

    // The Riccati adjoint's terms, with S = Gbar + Gbar^T.
    T Sm[MM], Su[M], aTSu[M], Sa[MM], SaF[MM];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) Sm[i * M + j] = G[i * M + j] + G[j * M + i];
    T uSu = T(0), wmu = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += Sm[i * M + j] * el.u[j];
      Su[i] = acc;
      uSu += el.u[i] * acc;
      wmu += el.wd[i] * lam[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < M; ++i) acc += el.a[i * M + j] * Su[i];
      aTSu[j] = acc;
    }
    mm<T, M>(Sm, el.a, Sa);
    mm<T, M>(Sa, el.F, SaF);

    const T ic2 = el.ic2, ic4 = ic2 * ic2;
    dbar[k] = S(c2bar - T(0.5) * uSu * ic4);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = -(el.alphabar * el.ic + wmu) * el.e[j] - c2bar * el.Fp[j] +
              uSu * ic4 * el.Fp[j];
      T fa = T(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        acc += el.F[i * M + j] * Fpbar[i];
        fa += el.F[j * M + i] * aTSu[i];
      }
      psbar[j * n + k] = S(acc - fa * ic2);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      qsbar[i * n + k] = S(ubar[i] + Su[i] * ic2);
#pragma unroll
      for (int j = 0; j < M; ++j)
        asbar[(i * M + j) * n + k] =
            S(lam[i] * el.e[j] - ubar[i] * el.Fp[j] + SaF[i * M + j] -
              Su[i] * el.Fp[j] * ic2);
    }
    ybar[k] = S(el.alphabar * el.ic + wmu);

    // Step both adjoint recurrences past element k.
    el.adjoint_step(lam);
    T At[MM], t1[MM], next[MM];
    el.transition_t(At);
    mm<T, M>(At, G, t1);
    mm_nt<T, M>(t1, At, next);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) G[i * M + j] = next[i * M + j] + Fpbar[i] * el.p[j];
  }
}

// ------------------------------------------------------------------- host side

// Workspace layout, in elements of Acc.
template <int M>
struct BwdLayout {
  static constexpr int MM = M * M;
  long long nb, nt, aff_local, aff_block, mu_start, cong_local, cong_block,
      total;
  explicit BwdLayout(long long n) {
    nb = num_blocks(n);
    nt = nb * kThreads;
    aff_local = 0;
    aff_block = aff_local + nt * (MM + M);
    mu_start = aff_block + nb * (MM + M);
    cong_local = mu_start + nt * M;
    cong_block = cong_local + nt * 2 * MM;
    total = cong_block + nb * 2 * MM;
  }
};

long long bwd_workspace_elems(int m, long long n) {
  switch (m) {
    case 1: return BwdLayout<1>(n).total;
    case 2: return BwdLayout<2>(n).total;
    case 3: return BwdLayout<3>(n).total;
    case 4: return BwdLayout<4>(n).total;
    default: return -1;
  }
}

template <typename S>
struct BwdArgs {
  const S *ps, *qs, *as, *y, *Fs, *es, *ics, *qbar, *lbar;
  S *dbar, *psbar, *qsbar, *asbar, *ybar;
};

template <typename S, int M>
cudaError_t run_bwd(long long n, const BwdArgs<S>& x, Acc* work, cudaStream_t s) {
  using T = Acc;
  using A = Aff<T, M>;
  using C = Cong<T, M>;
  const BwdLayout<M> L(n);
  const int nb = (int)L.nb;
  T* aff_local = work + L.aff_local;
  T* aff_block = work + L.aff_block;
  T* mu_start = work + L.mu_start;
  T* cong_local = work + L.cong_local;
  T* cong_block = work + L.cong_block;
  const int at = scan_threads<A, T>(), ct = scan_threads<C, T>();

  adj_chunk<S, M><<<nb, kThreads, kThreads * A::S * sizeof(T), s>>>(
      n, x.ps, x.qs, x.as, x.y, x.Fs, x.es, x.ics, x.qbar, aff_local,
      aff_block);
  scan_totals<A, T><<<1, at, at * A::S * sizeof(T), s>>>(nb, aff_block);
  cong_chunk<S, M><<<nb, kThreads, kThreads * C::S * sizeof(T), s>>>(
      n, x.ps, x.qs, x.as, x.y, x.Fs, x.es, x.ics, x.qbar, x.lbar, aff_local,
      aff_block, mu_start, cong_local, cong_block);
  scan_totals<C, T><<<1, ct, ct * C::S * sizeof(T), s>>>(nb, cong_block);
  out_chunk<S, M><<<nb, kThreads, 0, s>>>(
      n, x.ps, x.qs, x.as, x.y, x.Fs, x.es, x.ics, x.qbar, x.lbar, mu_start,
      cong_local, cong_block, x.dbar, x.psbar, x.qsbar, x.asbar, x.ybar);
  return cudaGetLastError();
}

template <typename S>
int loglik_bwd(int m, long long n, const BwdArgs<S>& x, Acc* work,
               long long work_elems, void* stream) {
  if (n < 1 || num_blocks(n) > 0x7fffffffLL || bwd_workspace_elems(m, n) < 0 ||
      work_elems < bwd_workspace_elems(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)run_bwd<S, 1>(n, x, work, s);
    case 2: return (int)run_bwd<S, 2>(n, x, work, s);
    case 3: return (int)run_bwd<S, 3>(n, x, work, s);
    default: return (int)run_bwd<S, 4>(n, x, work, s);
  }
}

}  // namespace

extern "C" {

// Workspace the launch needs, in float64 elements; -1 for an unsupported m.
long long qsl_bwd_workspace_elems(int m, int n) { return bwd_workspace_elems(m, n); }

// The cotangents of (d, ps, qs, as, y) into dbar (n), psbar (m, n),
// qsbar (m, n), asbar (m*m, n) and ybar (n). qbar and lbar point to one
// value each on the device. Returns a cudaError_t code: nonzero if an
// argument is refused or a launch failed.
int qsl_loglik_bwd_f32(int m, int n, const float* ps, const float* qs,
                       const float* as, const float* y, const float* Fs,
                       const float* es, const float* ics, const float* qbar,
                       const float* lbar, float* dbar, float* psbar,
                       float* qsbar, float* asbar, float* ybar, double* work,
                       long long work_elems, void* stream) {
  const BwdArgs<float> x{ps, qs, as, y, Fs, es, ics, qbar, lbar,
                         dbar, psbar, qsbar, asbar, ybar};
  return loglik_bwd<float>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_bwd_f64(int m, int n, const double* ps, const double* qs,
                       const double* as, const double* y, const double* Fs,
                       const double* es, const double* ics, const double* qbar,
                       const double* lbar, double* dbar, double* psbar,
                       double* qsbar, double* asbar, double* ybar,
                       double* work, long long work_elems, void* stream) {
  const BwdArgs<double> x{ps, qs, as, y, Fs, es, ics, qbar, lbar,
                          dbar, psbar, qsbar, asbar, ybar};
  return loglik_bwd<double>(m, n, x, work, work_elems, stream);
}

const char* qsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
