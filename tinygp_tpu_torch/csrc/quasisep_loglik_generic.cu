// Kernels B1, B1r and B2 above m = 4 on Hopper (sm_90a).
//
// Replaces, for 4 < m <= 32, the TPU kernels of
// tinygp_tpu/solvers/quasisep/pallas_loglik.py: _loglik_kernel (line 86)
// with residuals=False (B1) and residuals=True (B1r), and _bwd_kernel
// (line 414, B2). The JAX package hands m > 3 to XLA (pallas_loglik.py:
// 70-71); the port computes these orders on the card. The C interface is
// quasisep_loglik.cu's and quasisep_loglik_bwd.cu's, symbol for symbol, so
// one binding serves both libraries.
//
// The math is theirs (see those files). Each entry runs as a short
// sequence on one stream instead of one fused kernel, since a fused chunk
// would hold several m x m matrices per thread:
//
//   B1, B1r: the Riccati flow F by the generic engine (quasisep_generic.cuh,
//            float64 output); emit_pass: the Cholesky emissions
//            c2 = d - p^T F p, u = q - a F p and the whitening elements
//            A = a - (u / c2) p^T, B = (u / c2) y; the affine scan e of
//            (A, B) by the engine; terms_pass: alpha = (y - p.e) / c and
//            per-block sums of alpha^2 and log c (B1r also writes F, e and
//            1/c in the operands' type); g_reduce: the two sums in a fixed
//            order, so the result is deterministic.
//   B2:      bwd_pre_pass: the emissions again from the residuals, the
//            transposed transitions A^T and the adjoint loads
//            ebar = -alphabar p / c; the reverse exclusive affine scan of
//            (A^T, ebar), mu; bwd_glue_pass: the congruence loads
//            Ybar = Fpbar p^T from mu; the reverse exclusive congruence
//            scan of (A^T, Ybar), Gbar; bwd_out_pass: the cotangents of
//            (d, ps, qs, as, y) from mu and Gbar.
//
// Every intermediate is float64 in the workspace, as in the fused kernels.
// The elementwise passes run one thread per element, reading component c
// of element k at [c * n + k], so a warp's loads are coalesced; their
// vectors sit in arrays of the order's bucket (8, 16 or 32).
//
// What bounds it: the engine's float64 merges (see quasisep_generic.cuh).
// B1 must read (m^2 + 2m + 2) values per element once; B1r writes
// m^2 + m + 1 more, B2 reads 2m^2 + 3m + 2 and writes m^2 + 2m + 2. The
// sequence moves more: F, the whitening elements and the adjoints make
// round trips through device memory in float64.

#include "quasisep_generic.cuh"

namespace {

constexpr int kElemThreads = 128;

long long elem_blocks(long long n) { return (n + kElemThreads - 1) / kElemThreads; }

// ------------------------------------------------------------- forward (B1)

template <typename S, int MX>
__global__ void __launch_bounds__(kElemThreads)
emit_pass(int m, long long n, const S* d, const S* ps, const S* qs, const S* as,
          const S* y, const Acc* F, Acc* A, Acc* B, Acc* c2s) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Acc p[MX], Fp[MX];
  for (int i = 0; i < m; ++i) p[i] = Acc(ps[i * n + k]);
  for (int i = 0; i < m; ++i) {
    Acc acc = Acc(0);
    for (int j = 0; j < m; ++j) acc += F[(i * m + j) * n + k] * p[j];
    Fp[i] = acc;
  }
  Acc c2 = Acc(d[k]);
  for (int i = 0; i < m; ++i) c2 -= p[i] * Fp[i];
  const Acc inv_c2 = Acc(1) / c2, yk = Acc(y[k]);
  for (int i = 0; i < m; ++i) {
    Acc u = Acc(qs[i * n + k]);
    for (int j = 0; j < m; ++j) u -= Acc(as[(i * m + j) * n + k]) * Fp[j];
    const Acc wd = u * inv_c2;
    for (int j = 0; j < m; ++j)
      A[(i * m + j) * n + k] = Acc(as[(i * m + j) * n + k]) - wd * p[j];
    B[i * n + k] = wd * yk;
  }
  c2s[k] = c2;
}

// Sum v0 and v1 over the block into partials[2b], partials[2b + 1].
__device__ void block_sums(Acc v0, Acc v1, Acc* partials) {
  Acc* sm = reinterpret_cast<Acc*>(qsl_smem);
  const int t = threadIdx.x, nt = blockDim.x;
  sm[t] = v0;
  sm[nt + t] = v1;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (t < s) {
      sm[t] += sm[t + s];
      sm[nt + t] += sm[nt + t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    partials[2 * (long long)blockIdx.x] = sm[0];
    partials[2 * (long long)blockIdx.x + 1] = sm[nt];
  }
}

// kRes: also write each element's residuals F, e and 1/c (B1r).
template <typename S, int MX, bool kRes>
__global__ void __launch_bounds__(kElemThreads)
terms_pass(int m, long long n, const S* ps, const S* y, const Acc* F,
           const Acc* e, const Acc* c2s, Acc* partials, S* Fs, S* es, S* ics) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Acc quad = Acc(0), logdet = Acc(0);
  if (k < n) {
    const Acc c = sqrt(c2s[k]);
    Acc pe = Acc(0);
    for (int i = 0; i < m; ++i) pe += Acc(ps[i * n + k]) * e[i * n + k];
    const Acc alpha = (Acc(y[k]) - pe) / c;
    quad = alpha * alpha;
    logdet = log(c);
    if constexpr (kRes) {
      for (int r = 0; r < m * m; ++r) Fs[r * n + k] = S(F[r * n + k]);
      for (int i = 0; i < m; ++i) es[i * n + k] = S(e[i * n + k]);
      ics[k] = S(Acc(1) / c);
    }
  }
  block_sums(quad, logdet, partials);
}

template <typename S>
__global__ void __launch_bounds__(kScanThreads)
g_reduce(long long nb, const Acc* partials, S* out) {
  Acc* sm = reinterpret_cast<Acc*>(qsl_smem);
  const int t = threadIdx.x;
  Acc quad = Acc(0), logdet = Acc(0);
  for (long long i = t; i < nb; i += kScanThreads) {
    quad += partials[2 * i];
    logdet += partials[2 * i + 1];
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

// Forward workspace, in Acc: F (m^2 n), the whitening elements A (m^2 n)
// and B (m n), e (m n), c2 (n), the block sums and one engine workspace.
struct FwdLayout {
  long long F, A, B, e, c2, partials, scan, total;
  FwdLayout(int m, long long n) {
    const long long mm = (long long)m * m;
    const long long ric = g_workspace_elems(g_spec(gRic, m, m, 1), n);
    const long long aff = g_workspace_elems(g_spec(gAff, m, m, 1), n);
    F = 0;
    A = F + mm * n;
    B = A + mm * n;
    e = B + m * n;
    c2 = e + m * n;
    partials = c2 + n;
    scan = partials + 2 * elem_blocks(n);
    total = scan + (ric > aff ? ric : aff);
  }
};

template <typename S, int MX>
cudaError_t run_fwd(int m, long long n, const S* d, const S* ps, const S* qs,
                     const S* as, const S* y, S* out, S* Fs, S* es, S* ics,
                     Acc* work, cudaStream_t st) {
  const FwdLayout L(m, n);
  Acc *F = work + L.F, *A = work + L.A, *B = work + L.B, *e = work + L.e;
  Acc *c2 = work + L.c2, *partials = work + L.partials, *scan = work + L.scan;
  const long long nb = elem_blocks(n);
  const dim3 grid((unsigned)nb);
  cudaError_t err = g_run<S, Acc>(g_spec(gRic, m, m, 1), n, 0, 0,
                                  GIn<S>{d, ps, qs, as}, F, scan, st);
  if (err == cudaSuccess)
    err = g_launch(emit_pass<S, MX>, grid, kElemThreads, 0, st, m, n, d, ps, qs,
                   as, y, (const Acc*)F, A, B, c2);
  if (err == cudaSuccess)
    err = g_run<Acc, Acc>(g_spec(gAff, m, m, 1), n, 0, 0,
                          GIn<Acc>{A, B, nullptr, nullptr}, e, scan, st);
  const long long sums_smem = 2LL * kElemThreads * sizeof(Acc);
  if (err == cudaSuccess) {
    if (Fs)
      err = g_launch(terms_pass<S, MX, true>, grid, kElemThreads, sums_smem, st, m,
                     n, ps, y, (const Acc*)F, (const Acc*)e, (const Acc*)c2,
                     partials, Fs, es, ics);
    else
      err = g_launch(terms_pass<S, MX, false>, grid, kElemThreads, sums_smem, st,
                     m, n, ps, y, (const Acc*)F, (const Acc*)e, (const Acc*)c2,
                     partials, Fs, es, ics);
  }
  if (err == cudaSuccess)
    err = g_launch(g_reduce<S>, dim3(1), kScanThreads,
                   2LL * kScanThreads * sizeof(Acc), st, nb,
                   (const Acc*)partials, out);
  return err;
}

// ------------------------------------------------------------ backward (B2)

// One element's forward emissions, recomputed from the residuals
// (quasisep_loglik_bwd.cu: BwdElem).
template <typename S, int MX>
struct GBwd {
  Acc p[MX], e[MX], Fp[MX], u[MX], wd[MX];
  Acc y, ic, ic2, r, alpha, alphabar;

  __device__ GBwd(int m, long long n, long long k, const S* ps, const S* qs,
                  const S* as, const S* y_, const S* Fs, const S* es,
                  const S* ics, Acc qb) {
    y = Acc(y_[k]);
    ic = Acc(ics[k]);
    ic2 = ic * ic;
    for (int i = 0; i < m; ++i) {
      p[i] = Acc(ps[i * n + k]);
      e[i] = Acc(es[i * n + k]);
    }
    Acc pe = Acc(0);
    for (int i = 0; i < m; ++i) {
      Acc acc = Acc(0);
      for (int j = 0; j < m; ++j) acc += Acc(Fs[(i * m + j) * n + k]) * p[j];
      Fp[i] = acc;
      pe += p[i] * e[i];
    }
    for (int i = 0; i < m; ++i) {
      Acc acc = Acc(qs[i * n + k]);
      for (int j = 0; j < m; ++j) acc -= Acc(as[(i * m + j) * n + k]) * Fp[j];
      u[i] = acc;
      wd[i] = acc * ic2;
    }
    r = y - pe;
    alpha = r * ic;
    alphabar = Acc(2) * qb * alpha;
  }

  // The cotangent glue from mu: ubar, c2bar and Fpbar (the congruence
  // load is Ybar = Fpbar p^T); wdbar = mu (y - p.e).
  __device__ void glue(int m, long long n, long long k, const S* as,
                       const Acc* mu, Acc lb, Acc* ubar, Acc& c2bar,
                       Acc* Fpbar) const {
    Acc uw = Acc(0);
    for (int i = 0; i < m; ++i) {
      const Acc wdbar = mu[i] * r;
      ubar[i] = wdbar * ic2;
      uw += u[i] * wdbar;
    }
    const Acc icbar = -lb / ic + alphabar * alpha / ic + Acc(2) * ic * uw;
    c2bar = Acc(-0.5) * icbar * ic * ic2;
    for (int j = 0; j < m; ++j) {
      Acc acc = -c2bar * p[j];
      for (int i = 0; i < m; ++i) acc -= Acc(as[(i * m + j) * n + k]) * ubar[i];
      Fpbar[j] = acc;
    }
  }
};

// The adjoint scans' transitions A^T = (a - wd p^T)^T and loads
// ebar = -(alphabar / c) p.
template <typename S, int MX>
__global__ void __launch_bounds__(kElemThreads)
bwd_pre_pass(int m, long long n, const S* ps, const S* qs, const S* as,
             const S* y, const S* Fs, const S* es, const S* ics, const S* qbar,
             Acc* At, Acc* ebar) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const GBwd<S, MX> el(m, n, k, ps, qs, as, y, Fs, es, ics, Acc(*qbar));
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < m; ++j)
      At[(j * m + i) * n + k] = Acc(as[(i * m + j) * n + k]) - el.wd[i] * el.p[j];
    ebar[i * n + k] = -(el.alphabar * el.ic) * el.p[i];
  }
}

template <typename S, int MX>
__global__ void __launch_bounds__(kElemThreads)
bwd_glue_pass(int m, long long n, const S* ps, const S* qs, const S* as,
              const S* y, const S* Fs, const S* es, const S* ics,
              const S* qbar, const S* lbar, const Acc* mu, Acc* Ybar) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const GBwd<S, MX> el(m, n, k, ps, qs, as, y, Fs, es, ics, Acc(*qbar));
  Acc lam[MX], ubar[MX], Fpbar[MX], c2bar;
  for (int i = 0; i < m; ++i) lam[i] = mu[i * n + k];
  el.glue(m, n, k, as, lam, Acc(*lbar), ubar, c2bar, Fpbar);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j) Ybar[(i * m + j) * n + k] = Fpbar[i] * el.p[j];
}

// The cotangents of (d, ps, qs, as, y) from mu and Gbar
// (quasisep_loglik_bwd.cu: out_chunk), with S = Gbar + Gbar^T.
template <typename S, int MX>
__global__ void __launch_bounds__(kElemThreads)
bwd_out_pass(int m, long long n, const S* ps, const S* qs, const S* as,
             const S* y, const S* Fs, const S* es, const S* ics, const S* qbar,
             const S* lbar, const Acc* mu, const Acc* G, S* dbar, S* psbar,
             S* qsbar, S* asbar, S* ybar) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const GBwd<S, MX> el(m, n, k, ps, qs, as, y, Fs, es, ics, Acc(*qbar));
  Acc lam[MX], ubar[MX], Fpbar[MX], Su[MX], aTSu[MX], row[MX], c2bar;
  for (int i = 0; i < m; ++i) lam[i] = mu[i * n + k];
  el.glue(m, n, k, as, lam, Acc(*lbar), ubar, c2bar, Fpbar);
  auto Sm = [&](int i, int j) { return G[(i * m + j) * n + k] + G[(j * m + i) * n + k]; };
  auto a = [&](int i, int j) { return Acc(as[(i * m + j) * n + k]); };
  auto F = [&](int i, int j) { return Acc(Fs[(i * m + j) * n + k]); };
  Acc uSu = Acc(0), wmu = Acc(0);
  for (int i = 0; i < m; ++i) {
    Acc acc = Acc(0);
    for (int j = 0; j < m; ++j) acc += Sm(i, j) * el.u[j];
    Su[i] = acc;
    uSu += el.u[i] * acc;
    wmu += el.wd[i] * lam[i];
  }
  for (int j = 0; j < m; ++j) {
    Acc acc = Acc(0);
    for (int i = 0; i < m; ++i) acc += a(i, j) * Su[i];
    aTSu[j] = acc;
  }
  const Acc ic2 = el.ic2, ic4 = ic2 * ic2;
  dbar[k] = S(c2bar - Acc(0.5) * uSu * ic4);
  for (int j = 0; j < m; ++j) {
    Acc acc = -(el.alphabar * el.ic + wmu) * el.e[j] - c2bar * el.Fp[j] +
              uSu * ic4 * el.Fp[j];
    Acc fa = Acc(0);
    for (int i = 0; i < m; ++i) {
      acc += F(i, j) * Fpbar[i];
      fa += F(j, i) * aTSu[i];
    }
    psbar[j * n + k] = S(acc - fa * ic2);
  }
  for (int i = 0; i < m; ++i) {
    qsbar[i * n + k] = S(ubar[i] + Su[i] * ic2);
    // Row i of S a, then of (S a) F.
    for (int l = 0; l < m; ++l) {
      Acc acc = Acc(0);
      for (int r = 0; r < m; ++r) acc += Sm(i, r) * a(r, l);
      row[l] = acc;
    }
    for (int j = 0; j < m; ++j) {
      Acc saf = Acc(0);
      for (int l = 0; l < m; ++l) saf += row[l] * F(l, j);
      asbar[(i * m + j) * n + k] =
          S(lam[i] * el.e[j] - ubar[i] * el.Fp[j] + saf - Su[i] * el.Fp[j] * ic2);
    }
  }
  ybar[k] = S(el.alphabar * el.ic + wmu);
}

// Backward workspace, in Acc: A^T (m^2 n), ebar (m n), mu (m n),
// Ybar (m^2 n), Gbar (m^2 n) and one engine workspace.
struct BwdLayout {
  long long At, ebar, mu, Ybar, G, scan, total;
  BwdLayout(int m, long long n) {
    const long long mm = (long long)m * m;
    const long long aff = g_workspace_elems(g_spec(gAff, m, m, 1), n);
    const long long cong = g_workspace_elems(g_spec(gCong, m, m, 1), n);
    At = 0;
    ebar = At + mm * n;
    mu = ebar + m * n;
    Ybar = mu + m * n;
    G = Ybar + mm * n;
    scan = G + mm * n;
    total = scan + (aff > cong ? aff : cong);
  }
};

template <typename S>
struct BwdArgs {
  const S *ps, *qs, *as, *y, *Fs, *es, *ics, *qbar, *lbar;
  S *dbar, *psbar, *qsbar, *asbar, *ybar;
};

template <typename S, int MX>
cudaError_t run_bwd(int m, long long n, const BwdArgs<S>& x, Acc* work, cudaStream_t st) {
  const BwdLayout L(m, n);
  Acc *At = work + L.At, *ebar = work + L.ebar, *mu = work + L.mu;
  Acc *Ybar = work + L.Ybar, *G = work + L.G, *scan = work + L.scan;
  const dim3 grid((unsigned)elem_blocks(n));
  cudaError_t err = g_launch(bwd_pre_pass<S, MX>, grid, kElemThreads, 0, st, m, n,
                             x.ps, x.qs, x.as, x.y, x.Fs, x.es, x.ics, x.qbar, At, ebar);
  if (err == cudaSuccess)
    err = g_run<Acc, Acc>(g_spec(gAff, m, m, 1), n, 1, 0,
                          GIn<Acc>{At, ebar, nullptr, nullptr}, mu, scan, st);
  if (err == cudaSuccess)
    err = g_launch(bwd_glue_pass<S, MX>, grid, kElemThreads, 0, st, m, n, x.ps,
                   x.qs, x.as, x.y, x.Fs, x.es, x.ics, x.qbar, x.lbar,
                   (const Acc*)mu, Ybar);
  if (err == cudaSuccess)
    err = g_run<Acc, Acc>(g_spec(gCong, m, m, 1), n, 1, 0,
                          GIn<Acc>{At, Ybar, nullptr, nullptr}, G, scan, st);
  if (err == cudaSuccess)
    err = g_launch(bwd_out_pass<S, MX>, grid, kElemThreads, 0, st, m, n, x.ps,
                   x.qs, x.as, x.y, x.Fs, x.es, x.ics, x.qbar, x.lbar,
                   (const Acc*)mu, (const Acc*)G, x.dbar, x.psbar, x.qsbar,
                   x.asbar, x.ybar);
  return err;
}

// ---------------------------------------------------------------- dispatch

bool order_ok(int m, long long n) {
  return m > 4 && m <= kGenMaxM && n >= 1 && elem_blocks(n) <= 0x7fffffffLL;
}

template <typename S>
int loglik(int m, long long n, const S* d, const S* ps, const S* qs,
           const S* as, const S* y, S* out, S* Fs, S* es, S* ics, Acc* work,
           long long work_elems, void* stream) {
  if (!order_ok(m, n) || work_elems < FwdLayout(m, n).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)run_fwd<S, 8>(m, n, d, ps, qs, as, y, out, Fs, es, ics, work, st);
  if (m <= 16) return (int)run_fwd<S, 16>(m, n, d, ps, qs, as, y, out, Fs, es, ics, work, st);
  return (int)run_fwd<S, 32>(m, n, d, ps, qs, as, y, out, Fs, es, ics, work, st);
}

template <typename S>
int loglik_bwd(int m, long long n, const BwdArgs<S>& x, Acc* work,
               long long work_elems, void* stream) {
  if (!order_ok(m, n) || work_elems < BwdLayout(m, n).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)run_bwd<S, 8>(m, n, x, work, st);
  if (m <= 16) return (int)run_bwd<S, 16>(m, n, x, work, st);
  return (int)run_bwd<S, 32>(m, n, x, work, st);
}

}  // namespace

extern "C" {

// Workspaces, in float64 elements; -1 for an order this library does not
// take (it takes 4 < m <= 32).
long long qsl_workspace_elems(int m, int n) {
  return order_ok(m, n) ? FwdLayout(m, n).total : -1;
}

long long qsl_bwd_workspace_elems(int m, int n) {
  return order_ok(m, n) ? BwdLayout(m, n).total : -1;
}

// B1: (quad, logdet) into out[0], out[1].
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

// B1r: as B1, and the residuals F (m*m, n), e (m, n) and 1/c (n).
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

// B2: the cotangents of (d, ps, qs, as, y); qbar and lbar point to one
// value each on the device.
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
