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
//   B1, B1r: the Riccati flow by the generic engine (quasisep_generic.cuh),
//            whose finish pass emits, from the same step, the Cholesky
//            emissions c2 = d - p^T F p, u = q - a F p and the whitening
//            elements A = a - (u / c2) p^T, B = (u / c2) y in float64 (and
//            for B1r the residual F in the operands' type); the affine
//            scan e of (A, B) by the engine; terms_pass: alpha =
//            (y - p.e) / c and per-block sums of alpha^2 and log c (B1r
//            also writes e and 1/c); g_reduce: the two sums in a fixed
//            order, so the result is deterministic.
//   B2:      up to m = 8 one launch (b2_warp_kernel below); above, a
//            sequence: bwd_pre_pass: the emissions again from the residuals, the
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
// What bounds it: the engine's float64 arithmetic (see
// quasisep_generic.cuh). B1 must read (m^2 + 2m + 2) values per element
// once; B1r writes m^2 + m + 1 more, B2 reads 2m^2 + 3m + 2 and writes
// m^2 + 2m + 2. The sequence moves more: the whitening elements and the
// adjoints make round trips through device memory in float64.

#include "quasisep_generic.cuh"

namespace {

constexpr int kElemThreads = 128;

long long elem_blocks(long long n) { return (n + kElemThreads - 1) / kElemThreads; }

// ------------------------------------------------------------- forward (B1)

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

// kRes: also write each element's residuals e and 1/c (B1r; the Riccati
// finish pass wrote F).
template <typename S, int MX, bool kRes>
__global__ void __launch_bounds__(kElemThreads)
terms_pass(int m, long long n, const S* ps, const S* y, const Acc* e, const Acc* c2s,
           Acc* partials, S* es, S* ics) {
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

// Forward workspace, in Acc: the whitening elements A (m^2 n) and B (m n),
// e (m n), c2 (n), the block sums and one engine workspace.
struct FwdLayout {
  long long A, B, e, c2, partials, scan, total;
  FwdLayout(int m, long long n) {
    const long long mm = (long long)m * m;
    const long long ric = g_workspace_elems(g_spec(gRic, m, m, 1), n);
    const long long aff = g_workspace_elems(g_spec(gAff, m, m, 1), n);
    A = 0;
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
  Acc *A = work + L.A, *B = work + L.B, *e = work + L.e;
  Acc *c2 = work + L.c2, *partials = work + L.partials, *scan = work + L.scan;
  const long long nb = elem_blocks(n);
  const dim3 grid((unsigned)nb);
  cudaError_t err = g_run<S, Acc>(g_spec(gRic, m, m, 1), n, 0, 0, GIn<S>{d, ps, qs, as},
                                  (Acc*)nullptr, scan, st, RicEmit<S>{y, A, B, c2, Fs});
  if (err == cudaSuccess)
    err = g_run<Acc, Acc>(g_spec(gAff, m, m, 1), n, 0, 0, GIn<Acc>{A, B, nullptr, nullptr}, e,
                          scan, st);
  const long long sums_smem = 2LL * kElemThreads * sizeof(Acc);
  if (err == cudaSuccess) {
    if (Fs)
      err = g_launch(terms_pass<S, MX, true>, grid, kElemThreads, sums_smem, st, m,
                     n, ps, y, (const Acc*)e, (const Acc*)c2, partials, es, ics);
    else
      err = g_launch(terms_pass<S, MX, false>, grid, kElemThreads, sums_smem, st,
                     m, n, ps, y, (const Acc*)e, (const Acc*)c2, partials, es, ics);
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

template <typename S>
struct BwdArgs {
  const S *ps, *qs, *as, *y, *Fs, *es, *ics, *qbar, *lbar;
  S *dbar, *psbar, *qsbar, *asbar, *ybar;
};

// -------------------------------------- backward (B2) at m = 5..8: one launch
//
// The design of quasisep_loglik_bwd.cu (tiles taken by a ticket, staged
// once with cp.async, three walks and two look-backs; see there and
// quasisep_common.cuh) with a warp for a team: a thread cannot hold a
// congruence map (2 m^2 doubles, 128 at m = 8) beside its element. Each of
// the kB2Teams warps of a block walks sub consecutive positions of the
// tile, one element at a time, its running values in shared memory and the
// products split over its lanes (an output entry or two a lane), with
// __syncwarp between them; the order is a compile-time constant (5..8).
// The staged components lie T + 1 apart (odd), so lanes reading different
// components of one element hit different banks. Each element's emissions,
// which neither recurrence changes (Fp, u, wd and the scalars), are
// computed once per tile, one thread an element, so that a team's walks
// only step the recurrences. The in-tile scan over the teams is
// Kogge-Stone (two rounds of warp merges, quasisep_generic.cuh:
// g_combine); the look-back stages kB2GenWindow aggregates at a time and
// folds or applies them with the warp. Above m = 8 B2 runs the sequence
// below.

constexpr int kB2Teams = 4;      // warp teams per tile
constexpr int kB2GenWindow = 8;  // aggregates a look-back stages at once
constexpr int kB2MaxM = 8;       // the one-launch kernel's largest order

// Elements per team: 32 (tiles of 128), fewer where a block would then
// take more than half a multiprocessor's shared memory (b2g_smem: 16 at
// m = 7, m = 6 in float64 and m = 8 in float32, 8 at m = 8 in float64).
// cuda_loglik._B2_SCHEDULE repeats it.
__host__ __device__ constexpr int b2g_sub(int m, int bytes) {
  return m == 8 ? (bytes == 8 ? 8 : 16) : m == 7 || (bytes == 8 && m == 6) ? 16 : 32;
}

// The workspace (quasisep_common.cuh: LookLayout): the affine scan (maps
// of m^2 + m, states of m), then the congruence scan (2 m^2, m^2).
inline LookLayout b2g_layout(int m, int bytes, long long n) {
  const long long tile = kB2Teams * b2g_sub(m, bytes);
  return LookLayout((n + tile - 1) / tile, m * m + m, m, 2 * m * m, m * m);
}

// A team's shared values, in Acc: the element's Fpbar, the recurrences'
// mu (at the team's start, current and next) and Su, aTSu;
// the matrices T, Tn, B, X, G, Gn, Sa; two affine running values
// [A | B] (m x (m + 1)).
__host__ __device__ constexpr int b2g_team_elems(int m) { return 7 * m * m + 2 * m * (m + 1) + 6 * m; }

// An element's emissions, kept for the walks: Fp, u, wd and six scalars.
__host__ __device__ constexpr int b2g_emit_elems(int m) { return 3 * m + 6; }

// Shared memory of a block, in bytes: the look-back window and its three
// maps (Q, its next value, the group's aggregate), the scan's values (two
// buffers of one per team; the last team's is the tile's aggregate), the
// state at the tile's start and two state buffers, the teams' values, the
// elements' emissions (all Acc), then the staged tile.
__host__ __device__ constexpr long long b2g_smem(int m, int bytes) {
  const int mm = m * m, tile = kB2Teams * b2g_sub(m, bytes);
  return (long long)((kB2GenWindow + 3) * 2 * mm + 2 * kB2Teams * 2 * mm + 3 * mm +
                     kB2Teams * b2g_team_elems(m) + tile * b2g_emit_elems(m)) * sizeof(Acc) +
         (long long)(2 + 3 * m + 2 * mm) * (tile + 1) * bytes;
}

// The warp applies the affine map [A | B] (s <- A s + B) or the congruence
// map [T | B] (G <- T G T^T + B) to the state s in place; tmp: m^2 values.
template <int M, bool kCong>
__device__ __forceinline__ void warp_apply(const WarpTeam& tm, const Acc* map, Acc* s, Acc* tmp) {
  constexpr int MM = M * M;
  if constexpr (kCong) {
    gmm<M>(tm, M, M, M, map, M, false, s, M, false, tmp, M);
    gmm<M>(tm, M, M, M, tmp, M, false, map, M, true, s, M, map + MM, M);
  } else {
    const int lane = tm.rank();
    if (lane < M) {
      Acc acc = map[MM + lane];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += map[lane * M + j] * s[j];
      tmp[lane] = acc;
    }
    tm.sync();
    if (lane < M) s[lane] = tmp[lane];
    tm.sync();
  }
}

// By warp 0: publish `size` values of src at dst, then set *flag to v.
__device__ __forceinline__ void warp_publish(const WarpTeam& tm, const Acc* src, Acc* dst,
                                             int size, unsigned* flag, unsigned v) {
  for (int c = tm.rank(); c < size; c += 32) dst[c] = src[c];
  __threadfence();
  tm.sync();
  if (tm.rank() == 0) st_release(flag, v);
}

// By warp 0, once the tile's aggregate agg (shared memory) is final: the
// scan's state before tile b into st (shared memory), publishing what later
// tiles need (quasisep_common.cuh: the one-launch look-back), with the
// warp's products; lk holds three maps (Q, its next value, the group's
// aggregate), s and tmp a state and m^2 values.
template <int M, bool kCong>
__device__ void warp_group_lookback(const WarpTeam& tm, const GSpec& spec, long long b,
                                    long long nt, const LookSlots& sl, const Acc* agg, Acc* win,
                                    Acc* lk, Acc* st, Acc* s, Acc* tmp) {
  constexpr int MM = M * M, MAP = kCong ? 2 * MM : MM + M, SZ = kCong ? MM : M;
  const int lane = tm.rank();
  const long long g = b / kLookGroup, base = g * kLookGroup;
  const bool end = b % kLookGroup == kLookGroup - 1, more = b + 1 < nt;
  if (!end && more) warp_publish(tm, agg, sl.tile_agg + b * MAP, MAP, sl.tile_flag + b, 1u);
  // Q: the aggregates of the group's tiles before b, folded in order.
  Acc *Q = lk, *Qn = lk + 2 * MM, *GA = lk + 4 * MM;
  for (int c = lane; c < MAP; c += 32) Q[c] = c < MM && c / M == c % M ? Acc(1) : Acc(0);
  const int cnt = (int)(b - base);
  if (cnt > 0) {
    if (lane < cnt) wait_nonzero(sl.tile_flag + base + lane);
    tm.sync();
    __threadfence();
  }
  for (int i0 = 0; i0 < cnt; i0 += kB2GenWindow) {
    const int n_win = cnt - i0 < kB2GenWindow ? cnt - i0 : kB2GenWindow;
    lookback_window(sl.tile_agg, base + i0, n_win, MAP, win);
    for (int l = 0; l < n_win; ++l) {
      g_combine<M>(tm, spec, 1, Q, win + l * MAP, Qn, tmp, nullptr);
      Acc* swap = Q;
      Q = Qn;
      Qn = swap;
    }
  }
  tm.sync();
  if (end && more) {
    g_combine<M>(tm, spec, 1, Q, agg, GA, tmp, nullptr);
    warp_publish(tm, GA, sl.group_agg + g * MAP, MAP, sl.group_flag + g, 1u);
  }
  // S(g - 1): from the nearest group whose end state is published.
  const long long j = lookback_find(g, sl.group_flag);
  for (int c = lane; c < SZ; c += 32) s[c] = j >= 0 ? __ldcg(sl.group_state + j * SZ + c) : Acc(0);
  tm.sync();
  for (long long i0 = j + 1; i0 < g; i0 += kB2GenWindow) {
    const int n_win = (int)(g - i0 < kB2GenWindow ? g - i0 : kB2GenWindow);
    lookback_window(sl.group_agg, i0, n_win, MAP, win);
    for (int l = 0; l < n_win; ++l) warp_apply<M, kCong>(tm, win + l * MAP, s, tmp);
  }
  for (int c = lane; c < SZ; c += 32) st[c] = s[c];
  tm.sync();
  warp_apply<M, kCong>(tm, Q, st, tmp);
  if (end && more) {
    warp_apply<M, kCong>(tm, GA, s, tmp);
    warp_publish(tm, s, sl.group_state + g * SZ, SZ, sl.group_flag + g, 2u);
  }
}


// The in-tile Kogge-Stone scan of the teams' values sv[0][w] (size values
// each, written by the teams before the call): on return sv[0][w] holds
// team w's inclusive value (sv[1] is scratch). Every thread calls it.
template <int M>
__device__ void team_scan(const WarpTeam& tm, const GSpec& s, Acc* sv, int size, Acc* scr) {
  const int w = threadIdx.x >> 5;
  const int stride = kB2Teams * 2 * M * M;  // one buffer
  __syncthreads();
  int cur = 0;
  for (int off = 1; off < kB2Teams; off <<= 1, cur ^= 1) {
    const Acc* in = sv + cur * stride;
    Acc* out = sv + (cur ^ 1) * stride;
    if (w >= off)
      g_combine<M>(tm, s, 1, in + (w - off) * 2 * M * M, in + w * 2 * M * M, out + w * 2 * M * M,
                   scr, nullptr);
    else
      for (int c = tm.rank(); c < size; c += 32) out[w * 2 * M * M + c] = in[w * 2 * M * M + c];
    __syncthreads();
  }
  if (cur == 1) {  // the result is in the second buffer: copy it back
    for (int c = tm.rank(); c < size; c += 32) sv[w * 2 * M * M + c] = sv[stride + w * 2 * M * M + c];
    __syncthreads();
  }
}

template <typename S, int M>
__global__ void __launch_bounds__(32 * kB2Teams)
b2_warp_kernel(long long n, BwdArgs<S> x, Acc* work, LookLayout lay) {
  constexpr int MM = M * M, SUB = b2g_sub(M, sizeof(S)), T = kB2Teams * SUB, LD = T + 1;
  constexpr int W1 = M + 1, AS = MM + M, CS = 2 * MM, DS = b2g_emit_elems(M);
  // Staged components [y | ic | p | q | e | a | F] and outputs
  // [dbar | ybar | psbar | qsbar | asbar] (over the inputs, as in
  // quasisep_loglik_bwd.cu).
  constexpr int OY = 0, OIC = 1, OP = 2, OQ = 2 + M, OE = 2 + 2 * M, OA = 2 + 3 * M,
                OF = 2 + 3 * M + MM, IN = 2 + 3 * M + 2 * MM, OUT = 2 + 2 * M + MM;
  const WarpTeam tm;
  __shared__ long long tile_of_block;
  const LookSlots aff_sl = lay.slots(work, 0), cong_sl = lay.slots(work, 1);
  Acc* win = reinterpret_cast<Acc*>(qsl_smem);
  Acc* lk = win + kB2GenWindow * CS;
  Acc* sv = lk + 3 * CS;
  Acc* start = sv + 2 * kB2Teams * CS;
  Acc* lks = start + MM;
  Acc* stmp = lks + MM;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  Acc* team = stmp + MM + w * b2g_team_elems(M);
  Acc *Fpbar = team, *mu0 = Fpbar + M;
  Acc *lam = mu0 + M, *lamn = lam + M, *Su = lamn + M, *aTSu = Su + M;
  Acc *Tm = aTSu + M, *Tn = Tm + MM, *Bm = Tn + MM, *X = Bm + MM, *G = X + MM, *Gn = G + MM;
  Acc *Sa = Gn + MM, *V0 = Sa + MM, *V1 = V0 + M * W1;
  Acc* D = stmp + MM + kB2Teams * b2g_team_elems(M);
  S* st = reinterpret_cast<S*>(D + T * DS);
  const GSpec aff_spec{gAff, M, M, 1, 1}, cong_spec{gCong, M, M, 1, 1};

  if (t == 0) tile_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  const long long b = tile_of_block, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);

  // Stage the tile: position i (element n - 1 - p0 - i) of component c at
  // st[c * LD + i].
  for (int c = 0; c < IN; ++c) {
    const S* src = c == OY    ? x.y
                   : c == OIC ? x.ics
                   : c < OQ   ? x.ps + (long long)(c - OP) * n
                   : c < OE   ? x.qs + (long long)(c - OQ) * n
                   : c < OA   ? x.es + (long long)(c - OE) * n
                   : c < OF   ? x.as + (long long)(c - OA) * n
                              : x.Fs + (long long)(c - OF) * n;
    src += n - 1 - p0;
    for (int i = t; i < cnt; i += 32 * kB2Teams) cp_async_elem(st + c * LD + i, src - i);
  }
  cp_async_commit();
  const Acc qb = Acc(*x.qbar), lb = Acc(*x.lbar);
  cp_async_wait_all();
  __syncthreads();
  const int lo = w * SUB, mine = max(0, min(SUB, cnt - lo));
  const auto in = [&](int c, int pos) { return Acc(st[c * LD + pos]); };
  // Each element's emissions, which neither recurrence changes, one thread
  // an element: [Fp | u | wd | ic | ic^2 | r | alpha | alphabar | k0] at
  // D[pos * DS], with k0 = -lbar / ic + alphabar alpha / ic, the part of
  // icbar without mu.
  for (int pos = t; pos < cnt; pos += 32 * kB2Teams) {
    Acc* d = D + pos * DS;
    Acc p[M];
#pragma unroll
    for (int i = 0; i < M; ++i) p[i] = in(OP + i, pos);
    const Acc ic = in(OIC, pos), ic2 = ic * ic;
    Acc pe = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = Acc(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += in(OF + i * M + j, pos) * p[j];
      d[i] = acc;
      pe += p[i] * in(OE + i, pos);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = in(OQ + i, pos);
#pragma unroll
      for (int j = 0; j < M; ++j) acc -= in(OA + i * M + j, pos) * d[j];
      d[M + i] = acc;
      d[2 * M + i] = acc * ic2;
    }
    const Acc r = in(OY, pos) - pe, alpha = r * ic, alphabar = Acc(2) * qb * alpha;
    d[3 * M] = ic;
    d[3 * M + 1] = ic2;
    d[3 * M + 2] = r;
    d[3 * M + 3] = alpha;
    d[3 * M + 4] = alphabar;
    d[3 * M + 5] = -lb / ic + alphabar * alpha / ic;
  }
  __syncthreads();
  const auto Dv = [&](int pos, int c) { return D[pos * DS + c]; };
  // A^T (i, l) = a (l, i) - wd_l p_i of the element at pos.
  const auto At = [&](int i, int l, int pos) {
    return in(OA + l * M + i, pos) - Dv(pos, 2 * M + l) * in(OP + i, pos);
  };
  struct Scalars {
    Acc ic, ic2, r, alpha, alphabar, k0;
  };
  const auto prep = [&](int pos) {
    const Acc* d = D + pos * DS + 3 * M;
    return Scalars{d[0], d[1], d[2], d[3], d[4], d[5]};
  };
  // The glue from mu (lam) into Fpbar (lanes < m, and mu's next value
  // into lamn); returns c2bar (every lane).
  const auto glue = [&](int pos, const Scalars& sc) {
    Acc uw = Acc(0), wl = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      uw += Dv(pos, M + i) * (lam[i] * sc.r);
      wl += Dv(pos, 2 * M + i) * lam[i];
    }
    const Acc icbar = sc.k0 + Acc(2) * sc.ic * uw;
    const Acc c2bar = Acc(-0.5) * icbar * sc.ic * sc.ic2;
    if (lane < M) {
      const int j = lane;
      const Acc pj = in(OP + j, pos);
      Acc fpb = -c2bar * pj, nx = -(wl + sc.alphabar * sc.ic) * pj;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const Acc aij = in(OA + i * M + j, pos);
        fpb -= aij * (lam[i] * sc.r * sc.ic2);
        nx += aij * lam[i];
      }
      Fpbar[j] = fpb;
      lamn[j] = nx;
    }
    return c2bar;
  };
  const auto swap = [](Acc*& a, Acc*& b) {
    Acc* c = a;
    a = b;
    b = c;
  };

  // Phase A: the affine adjoint.
  {
    Acc *cur = V0, *nxt = V1;
    for (int e = lane; e < M * W1; e += 32) cur[e] = e / W1 == e % W1 ? Acc(1) : Acc(0);
    tm.sync();
    for (int jj = 0; jj < mine; ++jj) {
      const int pos = lo + jj;
      const Scalars sc = prep(pos);
      // [A | B]' = A^T [A | B] + [0 | ebar], ebar = -alphabar ic p.
      for (int e = lane; e < M * W1; e += 32) {
        const int i = e / W1, j = e - i * W1;
        Acc acc = j == M ? -(sc.alphabar * sc.ic) * in(OP + i, pos) : Acc(0);
#pragma unroll
        for (int l = 0; l < M; ++l) acc += At(i, l, pos) * cur[l * W1 + j];
        nxt[e] = acc;
      }
      tm.sync();
      swap(cur, nxt);
    }
    Acc* mine_v = sv + w * CS;
    for (int e = lane; e < AS; e += 32)
      mine_v[e] = e < MM ? cur[(e / M) * W1 + e % M] : cur[(e - MM) * W1 + M];
  }
  team_scan<M>(tm, aff_spec, sv, AS, X);
  const Acc* agg = sv + (kB2Teams - 1) * CS;
  if (w == 0)
    warp_group_lookback<M, false>(tm, aff_spec, b, lay.nt, aff_sl, agg, win, lk, start, lks, stmp);
  __syncthreads();
  // mu at the team's first element.
  for (int c = lane; c < M; c += 32) mu0[c] = start[c];
  tm.sync();
  if (w > 0) warp_apply<M, false>(tm, sv + (w - 1) * CS, mu0, X);
  __syncthreads();

  // Phase B: the congruence adjoint.
  for (int c = lane; c < M; c += 32) lam[c] = mu0[c];
  for (int e = lane; e < MM; e += 32) {
    Tm[e] = e / M == e % M ? Acc(1) : Acc(0);
    Bm[e] = Acc(0);
  }
  tm.sync();
  for (int jj = 0; jj < mine; ++jj) {
    const int pos = lo + jj;
    const Scalars sc = prep(pos);
    glue(pos, sc);
    // X = A^T B and Tn = A^T T.
    for (int e = lane; e < 2 * MM; e += 32) {
      const int f = e < MM ? e : e - MM, i = f / M, j = f - i * M;
      const Acc* R = e < MM ? Bm : Tm;
      Acc acc = Acc(0);
#pragma unroll
      for (int l = 0; l < M; ++l) acc += At(i, l, pos) * R[l * M + j];
      (e < MM ? X : Tn)[f] = acc;
    }
    tm.sync();
    // B = X A + Fpbar p^T, with A (l, j) = A^T (j, l).
    for (int e = lane; e < MM; e += 32) {
      const int i = e / M, j = e - i * M;
      Acc acc = Fpbar[i] * in(OP + j, pos);
#pragma unroll
      for (int l = 0; l < M; ++l) acc += X[i * M + l] * At(j, l, pos);
      Bm[e] = acc;
    }
    tm.sync();
    swap(Tm, Tn);
    swap(lam, lamn);
  }
  {
    Acc* mine_v = sv + w * CS;
    for (int e = lane; e < CS; e += 32) mine_v[e] = e < MM ? Tm[e] : Bm[e - MM];
  }
  team_scan<M>(tm, cong_spec, sv, CS, X);
  if (w == 0)
    warp_group_lookback<M, true>(tm, cong_spec, b, lay.nt, cong_sl, agg, win, lk, start, lks, stmp);
  __syncthreads();
  // Gbar at the team's first element.
  for (int c = lane; c < MM; c += 32) G[c] = start[c];
  tm.sync();
  if (w > 0) warp_apply<M, true>(tm, sv + (w - 1) * CS, G, X);

  // Phase C: both recurrences again; the cotangents over the inputs.
  for (int c = lane; c < M; c += 32) lam[c] = mu0[c];
  tm.sync();
  for (int jj = 0; jj < mine; ++jj) {
    const int pos = lo + jj;
    const Scalars sc = prep(pos);
    const Acc c2bar = glue(pos, sc);
    if (lane < M) {
      const int i = lane;
      Acc acc = Acc(0);
#pragma unroll
      for (int l = 0; l < M; ++l) acc += (G[i * M + l] + G[l * M + i]) * Dv(pos, M + l);
      Su[i] = acc;
    }
    for (int e = lane; e < MM; e += 32) {  // X = A^T G
      const int i = e / M, j = e - i * M;
      Acc acc = Acc(0);
#pragma unroll
      for (int l = 0; l < M; ++l) acc += At(i, l, pos) * G[l * M + j];
      X[e] = acc;
    }
    tm.sync();
    Acc uSu = Acc(0), wmu = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      uSu += Dv(pos, M + i) * Su[i];
      wmu += Dv(pos, 2 * M + i) * lam[i];
    }
    if (lane < M) {
      const int j = lane;
      Acc acc = Acc(0);
#pragma unroll
      for (int i = 0; i < M; ++i) acc += in(OA + i * M + j, pos) * Su[i];
      aTSu[j] = acc;
    }
    for (int e = lane; e < MM; e += 32) {  // Sa = (G + G^T) a, Gn = X A + Fpbar p^T
      const int i = e / M, j = e - i * M;
      Acc sa = Acc(0), gn = Fpbar[i] * in(OP + j, pos);
#pragma unroll
      for (int l = 0; l < M; ++l) {
        sa += (G[i * M + l] + G[l * M + i]) * in(OA + l * M + j, pos);
        gn += X[i * M + l] * At(j, l, pos);
      }
      Sa[e] = sa;
      Gn[e] = gn;
    }
    tm.sync();
    const Acc ic2 = sc.ic2, ic4 = ic2 * ic2;
    Acc o_as[(MM + 31) / 32], o_ps = Acc(0), o_qs = Acc(0);
#pragma unroll
    for (int q = 0; q < (MM + 31) / 32; ++q) {
      const int e = lane + 32 * q;
      if (e < MM) {
        const int i = e / M, j = e - i * M;
        Acc saf = Acc(0);
#pragma unroll
        for (int l = 0; l < M; ++l) saf += Sa[i * M + l] * in(OF + l * M + j, pos);
        const Acc fpj = Dv(pos, j);
        o_as[q] = lam[i] * in(OE + j, pos) - lam[i] * sc.r * ic2 * fpj + saf - Su[i] * fpj * ic2;
      }
    }
    if (lane < M) {
      const int j = lane;
      Acc acc = -(sc.alphabar * sc.ic + wmu) * in(OE + j, pos) - c2bar * Dv(pos, j) + uSu * ic4 * Dv(pos, j);
      Acc fa = Acc(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        acc += in(OF + i * M + j, pos) * Fpbar[i];
        fa += in(OF + j * M + i, pos) * aTSu[i];
      }
      o_ps = acc - fa * ic2;
      o_qs = lam[j] * sc.r * ic2 + Su[j] * ic2;
    }
    const Acc o_d = c2bar - Acc(0.5) * uSu * ic4, o_y = sc.alphabar * sc.ic + wmu;
    tm.sync();
    // Every read of the element's inputs is done: its outputs go over them.
    S* out = st + pos;
#pragma unroll
    for (int q = 0; q < (MM + 31) / 32; ++q)
      if (lane + 32 * q < MM) out[(2 + 2 * M + lane + 32 * q) * LD] = S(o_as[q]);
    if (lane < M) {
      out[(2 + lane) * LD] = S(o_ps);
      out[(2 + M + lane) * LD] = S(o_qs);
    }
    if (lane == 0) {
      out[0] = S(o_d);
      out[LD] = S(o_y);
    }
    swap(lam, lamn);
    swap(G, Gn);
  }
  __syncthreads();
  for (int c = 0; c < OUT; ++c) {
    S* dst = c == 0           ? x.dbar
             : c == 1         ? x.ybar
             : c < 2 + M      ? x.psbar + (long long)(c - 2) * n
             : c < 2 + 2 * M  ? x.qsbar + (long long)(c - 2 - M) * n
                              : x.asbar + (long long)(c - 2 - 2 * M) * n;
    dst += n - 1 - p0;
    for (int i = t; i < cnt; i += 32 * kB2Teams) dst[-i] = st[c * LD + i];
  }
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

// B2's workspace: at m <= kB2MaxM the one-launch kernel's for either
// storage type (the float64 tiles may be smaller), above the sequence's.
long long bwd_workspace(int m, long long n) {
  if (m > kB2MaxM) return BwdLayout(m, n).total;
  const long long f32 = b2g_layout(m, 4, n).total, f64 = b2g_layout(m, 8, n).total;
  return f32 > f64 ? f32 : f64;
}

// At m = 5..8: one memset (the ticket and the flags) and one launch.
template <typename S, int M>
cudaError_t run_b2_warp(long long n, const BwdArgs<S>& x, Acc* work, cudaStream_t st) {
  const LookLayout L = b2g_layout(M, sizeof(S), n);
  const cudaError_t e = cudaMemsetAsync(work + L.flags, 0, L.flag_words * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  return g_launch(b2_warp_kernel<S, M>, dim3((unsigned)L.nt), 32 * kB2Teams,
                  b2g_smem(M, sizeof(S)), st, n, x, work, L);
}

template <typename S>
int loglik_bwd(int m, long long n, const BwdArgs<S>& x, Acc* work,
               long long work_elems, void* stream) {
  if (!order_ok(m, n) || work_elems < bwd_workspace(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 5: return (int)run_b2_warp<S, 5>(n, x, work, st);
    case 6: return (int)run_b2_warp<S, 6>(n, x, work, st);
    case 7: return (int)run_b2_warp<S, 7>(n, x, work, st);
    case 8: return (int)run_b2_warp<S, 8>(n, x, work, st);
  }
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
  return order_ok(m, n) ? bwd_workspace(m, n) : -1;
}

// B2's association at m = 5..8 (the one-launch kernel) for operands of
// `bytes` bytes: elements per tile and per team (one warp) into tile[0],
// sub[0]; returns 0, or -1 where B2 runs the sequence instead (m > 8).
int qsl_bwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (m <= 4 || m > kB2MaxM || (bytes != 4 && bytes != 8)) return -1;
  *sub = b2g_sub(m, bytes);
  *tile = kB2Teams * b2g_sub(m, bytes);
  return 0;
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
