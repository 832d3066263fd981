// Backward of the quasiseparable GP log-likelihood on Hopper (sm_90a):
// kernel B2 at m = 1..4.
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
// elementwise in them (TileElem::glue and phase C below).
//
// Operands are stacked as in the forward kernel: y, ic of length n; ps, qs,
// e of shape (m, n); as, F of shape (m*m, n); all contiguous, in float32 or
// float64. qbar and lbar are single values in device memory, read by the
// kernel, so nothing waits on the host. Every scan runs in float64, as in
// the forward kernel; the outputs are stored in the operands' type.
//
// What bounds it: bytes. The function reads (2m^2 + 3m + 2) values per
// element and writes (m^2 + 2m + 2): (3m^2 + 5m + 4) values, 104 MB at
// n = 1e6 with m = 2 in float32, 31.0 us at 3.35 TB/s.
//
// Design: one launch, the GPU form of the TPU kernel's carried grid. A
// suffix scan is a prefix scan of the mirrored sequence (position
// j = n - 1 - k). Each block takes a tile of kB2Threads * sub consecutive
// positions by a ticket (quasisep_common.cuh: the one-launch look-back);
// thread t owns the sub positions t * sub .. t * sub + sub - 1 of it.
//
//   staging: every operand's run for the tile is contiguous, so the block
//            copies each component once, coalesced, with cp.async into
//            shared memory (thread t's element jj at slot jj * kB2Threads
//            + t, so that the phases' reads are conflict-free); nothing is
//            read from device memory again.
//   phase A: each thread folds its elements' (A^T, ebar) into one affine
//            map; a warp-shuffle Kogge-Stone scan per warp, the second
//            warp's values composed after the first warp's total, gives
//            each thread's exclusive prefix and the tile's aggregate; the
//            tile publishes it, and the look-back gives mu at the tile's
//            start (lambda starts at 0 at the sequence's end).
//   phase B: each thread walks its elements with the sequential mu
//            recurrence, forms the congruence loads Fpbar p^T and folds
//            each element as T' = A^T T, B' = A^T B A + Fpbar p^T (a
//            product and an outer product, no full merge); the same scan,
//            publication and look-back give Gbar at the tile's start.
//   phase C: each thread walks its elements once more with both
//            recurrences and puts the m^2 + 2m + 2 cotangents of each over
//            its inputs in shared memory; the block writes them out
//            coalesced.
//
// The look-back folds the aggregates of the earlier tiles of the tile's
// group in order and applies the earlier groups' aggregates to a
// published group state one group at a time, so its result is one fixed
// association whichever tiles it found published, and two launches on the
// same inputs agree bit for bit (quasisep_common.cuh).
// cuda_loglik.plain_loglik_bwd_tiled is this association in plain
// PyTorch. The ragged last tile is masked; nothing is padded. The cost
// against the bound: float64 arithmetic, and the latency of a tile's
// staging, three walks, two in-tile scans and two look-backs, with a few
// hundred threads a multiprocessor.
//
// A chain axis (qsl_loglik_bwd_chains_*) as in the forward kernel
// (quasisep_loglik.cu): tickets over (chain, tile), a workspace a chain, a
// stride an input (0 where shared); each chain bit for bit its unbatched
// launch.

#include "quasisep_common.cuh"

namespace {

constexpr int kB2Threads = kTileThreads;  // threads (teams of one) per tile

// Elements per thread: tiles of 512 elements at m <= 2, 128 at m = 3, 4.
// A tile's fixed cost (its staging latency, two in-tile scans, two
// look-backs) is then a smaller part of its time: at m = 2 on an H100,
// tiles of 256 took 0.16 ms of device time at N = 1e6 against 0.13 with
// 512, and no less at 1e5 (PERF.md §6). cuda_loglik._B2_SCHEDULE repeats
// it.
__host__ __device__ constexpr int b2_sub(int m) { return m <= 2 ? 8 : 2; }

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

// The staged components of an element, in shared memory: [y | ic | p (m) |
// q (m) | e (m) | a (m x m) | F (m x m)], component c of slot s at
// [c * ld + s]. Phase C puts the outputs [dbar | ybar | psbar (m) |
// qsbar (m) | asbar (m x m)] over the first of them.
template <int M>
struct B2Layout {
  static constexpr int MM = M * M, Y = 0, IC = 1, P = 2, Q = 2 + M, E = 2 + 2 * M,
                       A = 2 + 3 * M, F = 2 + 3 * M + MM, IN = 2 + 3 * M + 2 * MM,
                       OUT = 2 + 2 * M + MM;
};

// One element's residuals, read from its staged column, and the forward
// emissions recomputed from them; a and F stay in shared memory.
template <typename S, int M, int LD>
struct TileElem {
  using L = B2Layout<M>;
  static constexpr int MM = M * M;
  const S* col;
  Acc y, ic, ic2, r, alpha, alphabar;
  Acc p[M], e[M], Fp[M], u[M], wd[M];

  __device__ __forceinline__ Acc a(int i, int j) const { return Acc(col[(L::A + i * M + j) * LD]); }
  __device__ __forceinline__ Acc F(int i, int j) const { return Acc(col[(L::F + i * M + j) * LD]); }

  __device__ __forceinline__ TileElem(const S* col_, Acc qb) : col(col_) {
    y = Acc(col[L::Y * LD]);
    ic = Acc(col[L::IC * LD]);
    ic2 = ic * ic;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      p[i] = Acc(col[(L::P + i) * LD]);
      e[i] = Acc(col[(L::E + i) * LD]);
    }
    Acc pe = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = Acc(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += F(i, j) * p[j];
      Fp[i] = acc;
      pe += p[i] * e[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = Acc(col[(L::Q + i) * LD]);
#pragma unroll
      for (int j = 0; j < M; ++j) acc -= a(i, j) * Fp[j];
      u[i] = acc;
      wd[i] = acc * ic2;
    }
    r = y - pe;
    alpha = r * ic;
    alphabar = Acc(2) * qb * alpha;
  }

  // The transposed whitening transition A^T = (a - wd p^T)^T.
  __device__ __forceinline__ void transition_t(Acc* out) const {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) out[j * M + i] = a(i, j) - wd[i] * p[j];
  }

  // The affine-adjoint element (A^T, ebar), ebar = -alphabar ic p.
  __device__ __forceinline__ Aff<Acc, M> adjoint() const {
    Aff<Acc, M> x;
    transition_t(x.v);
#pragma unroll
    for (int i = 0; i < M; ++i) x.v[MM + i] = -(alphabar * ic) * p[i];
    return x;
  }

  // lambda <- A^T lambda + ebar, in place.
  __device__ __forceinline__ void adjoint_step(Acc* lam) const {
    Acc wl = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) wl += wd[i] * lam[i];
    Acc next[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Acc acc = -(wl + alphabar * ic) * p[j];
#pragma unroll
      for (int i = 0; i < M; ++i) acc += a(i, j) * lam[i];
      next[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < M; ++j) lam[j] = next[j];
  }

  // The cotangent glue from mu: ubar, c2bar and Fpbar (the congruence load
  // is Ybar = Fpbar p^T). wdbar = mu y - Abar p with Abar = mu e^T, which
  // is mu (y - p.e).
  __device__ __forceinline__ void glue(const Acc* mu, Acc lb, Acc* ubar, Acc& c2bar,
                                       Acc* Fpbar) const {
    Acc uw = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const Acc wdbar = mu[i] * r;
      ubar[i] = wdbar * ic2;
      uw += u[i] * wdbar;
    }
    const Acc icbar = -lb / ic + alphabar * alpha / ic + Acc(2) * ic * uw;
    c2bar = Acc(-0.5) * icbar * ic * ic2;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Acc acc = -c2bar * p[j];
#pragma unroll
      for (int i = 0; i < M; ++i) acc -= a(i, j) * ubar[i];
      Fpbar[j] = acc;
    }
  }

  // G <- A^T G A + Fpbar p^T, in place (the congruence step, and with
  // T <- A^T T the fold of the element into a running map).
  __device__ __forceinline__ void cong_step(const Acc* At, const Acc* Fpbar, Acc* G) const {
    Acc t1[MM], t2[MM];
    mm<Acc, M>(At, G, t1);
    mm_nt<Acc, M>(t1, At, t2);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) G[i * M + j] = t2[i * M + j] + Fpbar[i] * p[j];
  }
};

// The congruence state G <- T G T^T + B by one thread; map = [T | B].
template <int M>
__device__ __forceinline__ void cong_apply(const Acc* map, Acc* G) {
  constexpr int MM = M * M;
  Acc t1[MM], t2[MM];
  mm<Acc, M>(map, G, t1);
  mm_nt<Acc, M>(t1, map, t2);
#pragma unroll
  for (int c = 0; c < MM; ++c) G[c] = t2[c] + map[MM + c];
}

template <typename S>
struct BwdArgs {
  const S *ps, *qs, *as, *y, *Fs, *es, *ics, *qbar, *lbar;
  S *dbar, *psbar, *qsbar, *asbar, *ybar;
  // The chain strides of the nine inputs, in elements: 0 for an input that
  // every chain shares. The outputs are contiguous by chain.
  long long cs[9];

  // The inputs and outputs of chain c.
  __device__ __forceinline__ void shift(long long c, long long n, int m) {
    ps += c * cs[0];
    qs += c * cs[1];
    as += c * cs[2];
    y += c * cs[3];
    Fs += c * cs[4];
    es += c * cs[5];
    ics += c * cs[6];
    qbar += c * cs[7];
    lbar += c * cs[8];
    dbar += c * n;
    psbar += c * m * n;
    qsbar += c * m * n;
    asbar += c * m * m * n;
    ybar += c * n;
  }
};

// B2's workspace at order M (quasisep_common.cuh: LookLayout): the affine
// scan (maps of m^2 + m, states of m), then the congruence scan (2 m^2,
// m^2).
template <int M>
LookLayout b2_layout(long long n) {
  const long long tile = kB2Threads * b2_sub(M);
  return LookLayout((n + tile - 1) / tile, M * M + M, M, 2 * M * M, M * M);
}

// Shared memory of a block, in bytes: the look-back window, the scan's
// warp total, the tile's aggregate and the state at the tile's start (all
// Acc), then the staged tile.
template <typename S, int M>
constexpr long long b2_smem() {
  constexpr int MM = M * M, T = kB2Threads * b2_sub(M);
  return (long long)(kLookWindow * 2 * MM + 5 * MM) * sizeof(Acc) +
         (long long)B2Layout<M>::IN * (T + 1) * sizeof(S);
}

template <typename S, int M>
__global__ void __launch_bounds__(kB2Threads)
b2_tile_kernel(long long n, BwdArgs<S> x, Acc* work, LookLayout lay) {
  using L = B2Layout<M>;
  using A = Aff<Acc, M>;
  using C = Cong<Acc, M>;
  constexpr int MM = M * M, SUB = b2_sub(M), T = kB2Threads * SUB, LD = T + 1;
  using E = TileElem<S, M, LD>;
  __shared__ long long tile_of_block;
  Acc* win = reinterpret_cast<Acc*>(qsl_smem);
  Acc* scan_sm = win + kLookWindow * 2 * MM;
  Acc* agg = scan_sm + 2 * MM;
  Acc* start = agg + 2 * MM;
  S* st = reinterpret_cast<S*>(start + MM);
  const int t = threadIdx.x, warp = t >> 5;

  // The ticket runs over (chain, tile), chain-major, as in B1
  // (quasisep_loglik.cu); each chain has its own look-back workspace, the
  // first chain's holds the ticket.
  if (t == 0) tile_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  const long long chain = tile_of_block / lay.nt, b = tile_of_block - chain * lay.nt, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);
  work += chain * lay.total;
  x.shift(chain, n, M);
  const LookSlots aff_sl = lay.slots(work, 0), cong_sl = lay.slots(work, 1);

  // Stage the tile: position i (element n - 1 - p0 - i) of component c at
  // slot (i % SUB) * kB2Threads + i / SUB.
  for (int c = 0; c < L::IN; ++c) {
    const S* src = c == L::Y    ? x.y
                   : c == L::IC ? x.ics
                   : c < L::Q   ? x.ps + (long long)(c - L::P) * n
                   : c < L::E   ? x.qs + (long long)(c - L::Q) * n
                   : c < L::A   ? x.es + (long long)(c - L::E) * n
                   : c < L::F   ? x.as + (long long)(c - L::A) * n
                                : x.Fs + (long long)(c - L::F) * n;
    src += n - 1 - p0;
    for (int i = t; i < cnt; i += kB2Threads)
      cp_async_elem(st + c * LD + (i % SUB) * kB2Threads + i / SUB, src - i);
  }
  cp_async_commit();
  const Acc qb = Acc(*x.qbar), lb = Acc(*x.lbar);
  cp_async_wait_all();
  __syncthreads();
  const int mine = max(0, min(SUB, cnt - t * SUB));
  const auto col = [&](int jj) { return st + jj * kB2Threads + t; };

  // Phase A: the affine adjoint. The tile's aggregate, then mu at its
  // start from the look-back.
  A acc = A::identity();
  for (int jj = 0; jj < mine; ++jj) acc = A::combine(acc, E(col(jj), qb).adjoint());
  const A pre = tile_scan<A>(acc, scan_sm, agg);
  if (warp == 0)
    group_lookback<A, M>(b, lay.nt, aff_sl, agg, win, start,
                         [](const Acc* map, Acc* s) { aff_apply<M>(map, s); });
  __syncthreads();
  // mu at the thread's first element: its prefix applied to the tile's start.
  Acc mu0[M];
#pragma unroll
  for (int i = 0; i < M; ++i) mu0[i] = start[i];
  aff_apply<M>(pre.v, mu0);

  // Phase B: the congruence adjoint, its loads from the mu recurrence.
  C cacc = C::identity();
  {
    Acc lam[M];
#pragma unroll
    for (int i = 0; i < M; ++i) lam[i] = mu0[i];
    for (int jj = 0; jj < mine; ++jj) {
      const E el(col(jj), qb);
      Acc ubar[M], c2bar, Fpbar[M], At[MM], t1[MM];
      el.glue(lam, lb, ubar, c2bar, Fpbar);
      el.transition_t(At);
      mm<Acc, M>(At, cacc.v, t1);
#pragma unroll
      for (int c = 0; c < MM; ++c) cacc.v[c] = t1[c];
      el.cong_step(At, Fpbar, cacc.v + MM);
      el.adjoint_step(lam);
    }
  }
  const C cpre = tile_scan<C>(cacc, scan_sm, agg);
  if (warp == 0)
    group_lookback<C, MM>(b, lay.nt, cong_sl, agg, win, start,
                          [](const Acc* map, Acc* s) { cong_apply<M>(map, s); });
  __syncthreads();

  // Phase C: both recurrences again from the thread's start, and the
  // cotangents of each element over its staged inputs.
  Acc lam[M], G[MM];
#pragma unroll
  for (int i = 0; i < M; ++i) lam[i] = mu0[i];
#pragma unroll
  for (int c = 0; c < MM; ++c) G[c] = start[c];
  cong_apply<M>(cpre.v, G);
  for (int jj = 0; jj < mine; ++jj) {
    const E el(col(jj), qb);
    Acc ubar[M], c2bar, Fpbar[M];
    el.glue(lam, lb, ubar, c2bar, Fpbar);  // lam is mu_k here

    // The Riccati adjoint's terms, with Sm = Gbar + Gbar^T.
    Acc Sm[MM], Su[M], aTSu[M], o[L::OUT];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) Sm[i * M + j] = G[i * M + j] + G[j * M + i];
    Acc uSu = Acc(0), wmu = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = Acc(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += Sm[i * M + j] * el.u[j];
      Su[i] = acc;
      uSu += el.u[i] * acc;
      wmu += el.wd[i] * lam[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Acc acc = Acc(0);
#pragma unroll
      for (int i = 0; i < M; ++i) acc += el.a(i, j) * Su[i];
      aTSu[j] = acc;
    }
    const Acc ic2 = el.ic2, ic4 = ic2 * ic2;
    o[0] = c2bar - Acc(0.5) * uSu * ic4;
    o[1] = el.alphabar * el.ic + wmu;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Acc acc = -(el.alphabar * el.ic + wmu) * el.e[j] - c2bar * el.Fp[j] + uSu * ic4 * el.Fp[j];
      Acc fa = Acc(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        acc += el.F(i, j) * Fpbar[i];
        fa += el.F(j, i) * aTSu[i];
      }
      o[2 + j] = acc - fa * ic2;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      o[2 + M + i] = ubar[i] + Su[i] * ic2;
      // Row i of Sm a, then of (Sm a) F.
      Acc row[M];
#pragma unroll
      for (int l = 0; l < M; ++l) {
        Acc acc = Acc(0);
#pragma unroll
        for (int r = 0; r < M; ++r) acc += Sm[i * M + r] * el.a(r, l);
        row[l] = acc;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Acc saf = Acc(0);
#pragma unroll
        for (int l = 0; l < M; ++l) saf += row[l] * el.F(l, j);
        o[2 + 2 * M + i * M + j] =
            lam[i] * el.e[j] - ubar[i] * el.Fp[j] + saf - Su[i] * el.Fp[j] * ic2;
      }
    }

    // Step both adjoint recurrences past the element, then put its outputs
    // over its inputs (every read of them is done).
    Acc At[MM];
    el.transition_t(At);
    el.adjoint_step(lam);
    el.cong_step(At, Fpbar, G);
#pragma unroll
    for (int c = 0; c < L::OUT; ++c) col(jj)[c * LD] = S(o[c]);
  }
  __syncthreads();
  for (int c = 0; c < L::OUT; ++c) {
    S* dst = c == 0                 ? x.dbar
             : c == 1               ? x.ybar
             : c < 2 + M            ? x.psbar + (long long)(c - 2) * n
             : c < 2 + 2 * M        ? x.qsbar + (long long)(c - 2 - M) * n
                                    : x.asbar + (long long)(c - 2 - 2 * M) * n;
    dst += n - 1 - p0;
    for (int i = t; i < cnt; i += kB2Threads)
      dst[-i] = st[c * LD + (i % SUB) * kB2Threads + i / SUB];
  }
}

// ------------------------------------------------------------------- host side

long long bwd_workspace_elems(int m, long long n) {
  switch (m) {
    case 1: return b2_layout<1>(n).total;
    case 2: return b2_layout<2>(n).total;
    case 3: return b2_layout<3>(n).total;
    case 4: return b2_layout<4>(n).total;
    default: return -1;
  }
}

// One memset (each chain's flags, the first chain's ticket with them) and
// one launch of chains x tiles blocks, on stream s.
template <typename S, int M>
cudaError_t run_bwd(long long n, long long chains, const BwdArgs<S>& x, Acc* work,
                    cudaStream_t s) {
  const LookLayout L = b2_layout<M>(n);
  if (chains * L.nt >= (1ll << 31)) return cudaErrorInvalidValue;  // the grid, the ticket
  constexpr long long smem = b2_smem<S, M>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        b2_tile_kernel<S, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaMemset2DAsync(work + L.flags, L.total * sizeof(Acc), 0,
                                    L.flag_words * sizeof(unsigned), chains, s);
  if (e != cudaSuccess) return e;
  b2_tile_kernel<S, M><<<(unsigned)(chains * L.nt), kB2Threads, smem, s>>>(n, x, work, L);
  return cudaGetLastError();
}

template <typename S>
int loglik_bwd(int m, long long n, long long chains, const BwdArgs<S>& x, Acc* work,
               long long work_elems, void* stream) {
  if (n < 1 || chains < 1 || bwd_workspace_elems(m, n) < 0 ||
      work_elems < chains * bwd_workspace_elems(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)run_bwd<S, 1>(n, chains, x, work, s);
    case 2: return (int)run_bwd<S, 2>(n, chains, x, work, s);
    case 3: return (int)run_bwd<S, 3>(n, chains, x, work, s);
    default: return (int)run_bwd<S, 4>(n, chains, x, work, s);
  }
}

// The C entries' operands: the chain strides of the nine inputs, or all 0
// for one unbatched problem.
template <typename S>
BwdArgs<S> bwd_args(const S* ps, const S* qs, const S* as, const S* y, const S* Fs,
                    const S* es, const S* ics, const S* qbar, const S* lbar, S* dbar, S* psbar,
                    S* qsbar, S* asbar, S* ybar, const long long* strides) {
  BwdArgs<S> x{ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar, psbar, qsbar, asbar, ybar, {}};
  for (int k = 0; k < 9; ++k) x.cs[k] = strides ? strides[k] : 0;
  return x;
}

}  // namespace

extern "C" {

// Workspace the launch needs, in float64 elements, per chain; -1 for an
// unsupported m.
long long qsl_bwd_workspace_elems(int m, int n) { return bwd_workspace_elems(m, n); }

// The launch's association for operands of `bytes` bytes (the same for
// both): elements per tile and per team (one thread) into tile[0], sub[0];
// returns 0, or -1 for an unsupported m.
int qsl_bwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (m < 1 || m > 4 || (bytes != 4 && bytes != 8)) return -1;
  *sub = b2_sub(m);
  *tile = kB2Threads * b2_sub(m);
  return 0;
}

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
  const BwdArgs<float> x = bwd_args<float>(ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar, psbar,
                                           qsbar, asbar, ybar, nullptr);
  return loglik_bwd<float>(m, n, 1, x, work, work_elems, stream);
}

int qsl_loglik_bwd_f64(int m, int n, const double* ps, const double* qs,
                       const double* as, const double* y, const double* Fs,
                       const double* es, const double* ics, const double* qbar,
                       const double* lbar, double* dbar, double* psbar,
                       double* qsbar, double* asbar, double* ybar,
                       double* work, long long work_elems, void* stream) {
  const BwdArgs<double> x = bwd_args<double>(ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar,
                                             psbar, qsbar, asbar, ybar, nullptr);
  return loglik_bwd<double>(m, n, 1, x, work, work_elems, stream);
}

// B2 with a leading chain axis: `chains` problems of one order and length
// in one launch, chain c's input at its pointer plus c times its stride
// (strides: ps, qs, as, y, Fs, es, ics, qbar, lbar, in elements; 0 for an
// input that every chain shares), its outputs at dbar + c n, psbar + c m n,
// qsbar + c m n, asbar + c m^2 n, ybar + c n. Each chain's result is bit
// for bit that of the unbatched launch on its inputs. The workspace is
// `chains` times qsl_bwd_workspace_elems.
int qsl_loglik_bwd_chains_f32(int m, int n, int chains, const long long* strides,
                              const float* ps, const float* qs, const float* as, const float* y,
                              const float* Fs, const float* es, const float* ics,
                              const float* qbar, const float* lbar, float* dbar, float* psbar,
                              float* qsbar, float* asbar, float* ybar, double* work,
                              long long work_elems, void* stream) {
  const BwdArgs<float> x = bwd_args<float>(ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar, psbar,
                                           qsbar, asbar, ybar, strides);
  return loglik_bwd<float>(m, n, chains, x, work, work_elems, stream);
}

int qsl_loglik_bwd_chains_f64(int m, int n, int chains, const long long* strides,
                              const double* ps, const double* qs, const double* as,
                              const double* y, const double* Fs, const double* es,
                              const double* ics, const double* qbar, const double* lbar,
                              double* dbar, double* psbar, double* qsbar, double* asbar,
                              double* ybar, double* work, long long work_elems, void* stream) {
  const BwdArgs<double> x = bwd_args<double>(ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar,
                                             psbar, qsbar, asbar, ybar, strides);
  return loglik_bwd<double>(m, n, chains, x, work, work_elems, stream);
}

const char* qsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
