// Kernels B1, B1r and B2 at m = 5..16 on Hopper (sm_90a).
//
// Replaces, for 4 < m <= 16, the TPU kernels of
// tinygp_tpu/solvers/quasisep/pallas_loglik.py: _loglik_kernel (line 86)
// with residuals=False (B1) and residuals=True (B1r), and _bwd_kernel
// (line 414, B2). The JAX package hands m > 3 to XLA (pallas_loglik.py:
// 70-71); the port computes these orders on the card. The C interface is
// quasisep_loglik.cu's and quasisep_loglik_bwd.cu's, symbol for symbol, so
// one binding serves every library; m = 17..32 is quasisep_loglik_wide.cu,
// a library of its own so that the two build at once.
//
// The math is theirs (see those files). Each kernel is one launch and one
// memset of its flags: b1_tc_kernel (B1 and B1r), b2_warp_kernel (B2 at
// m = 5..8, a warp a team) and b2_tc_kernel (B2 at m = 9..16), the last two
// and the first on the float64 tensor cores through the one-launch scans'
// Ops (quasisep_tc.cuh).
//
// What bounds them: bytes. B1 must read (m^2 + 2m + 2) values per element
// once; B1r writes m^2 + m + 1 more, B2 reads 2m^2 + 3m + 2 and writes
// m^2 + 2m + 2. The float64 tensor cores (a few m^3 multiply-adds an
// element) are far from binding; the cost against the bound is latency
// (PERF.md).

#include "quasisep_tc.cuh"

namespace {

// ------------------------------------------ forward (B1, B1r) at m = 5..16
//
// b1_tc_kernel: the design of quasisep_loglik.cu's b1_tile_kernel (tiles
// taken by a ticket, staged once, the Riccati flow and then the whitening
// scan in the same tile, each with its own look-back chain, the sums in one
// fixed order) with a warp for a team and every product on the float64
// tensor cores: B3's one-launch skeleton (quasisep_generic.cu: mono_tile)
// run over RicOp<P> and then AffOp<P, 8> (quasisep_tc.cuh), maps padded to
// P = 8 (m <= 8) or 16 with zeros.
//
//   staging:  [d | p | q | a | y] of each element, one cp.async a value,
//             component c at st[c * LD + i] (LD = T + 1, odd);
//   phase A:  the Riccati flow. Each team folds its elements with the
//             rank-one step, the teams' maps are scanned in the tile
//             (mono_team_scan), the grouped look-back (mono_lookback) gives
//             the tile's start, and each team walks its elements from its
//             prefix, keeping each element's c2 = d - p^T F p and
//             wd = (q - a F p) / c2 in shared memory (D);
//   phase B:  the whitening scan e' = (a - wd p^T) e + wd y, one column
//             (AffOp<P, 8>'s column 0): fold, in-tile scan and look-back as
//             in phase A, on the second chain; its elements are formed
//             from the staged a, p, y and D, and never stored;
//   phase C:  each team walks e from its prefix: alpha = (y - p.e) / c,
//             and alpha^2 and log c summed in element order. B1r puts each
//             element's e and 1/c over its staged q and d, which the block
//             writes out coalesced; its F, the state before the element,
//             phase A's walk writes to device memory, a lane its entries
//             (walking the flow again in phase C cost a fifth more at
//             m = 5). The tile's sum adds the teams' in order; the last
//             tile to finish sums every tile's in tile order (b1_finish).
//
// Every product runs in float64 whatever the storage type and the
// look-backs compose in one fixed order, so two launches on the same inputs
// agree bit for bit; cuda_loglik.plain_loglik_terms_res_tiled is this
// association in plain PyTorch.

template <int P>
struct B1Tc {
  using Ric = RicOp<P>;
  using Aff = AffOp<P, 8>;
  static constexpr int MAP = Ric::kMap, ST = Ric::kState, SCR = Ric::kScratch;
  static constexpr int TEAM = 3 * MAP + SCR + ST;
  static_assert(Aff::kMap <= MAP && Aff::kState <= ST,
                "the whitening scan's maps and states fit the Riccati flow's slots");
  // Shared memory beside the staged tile and D, in bytes: the look-back's
  // three maps, the tile's start and a state, and per team three maps, the
  // merge's scratch and a state.
  static constexpr long long kFixed = (long long)(3 * MAP + 2 * ST + kMonoTeams * TEAM) * sizeof(Acc);
};

// Components staged an element, [d | p | q | a | y]; values kept in D:
// wd (m) and c2.
__host__ __device__ constexpr int b1t_in(int m) { return 2 + 2 * m + m * m; }

template <int P>
inline long long b1t_smem(int m, int bytes, int sub) {
  const long long tile = kMonoTeams * sub;
  return B1Tc<P>::kFixed + tile * (m + 1) * (long long)sizeof(Acc) +
         (long long)b1t_in(m) * (tile + 1) * bytes + 16;
}

// Elements per team: at P = 8 the most, up to 64, whose block leaves two
// blocks a multiprocessor; at P = 16, whose fixed part alone takes more
// than half a multiprocessor's shared memory, the most, up to 32, whose
// block fits 1 KB short of a block's. Each look-back group's end state
// waits on the group before it (an application of its map, with a pivoted
// inverse for the Riccati flow), so long tiles shorten that chain.
// cuda_loglik._B1_SCHEDULE repeats it.
template <int P>
inline int b1t_sub(int m, int bytes) {
  const long long room = P == 8 ? kGenSharedSM / 2 - 1024 : kGenSharedBlock - 1024;
  int sub = P == 8 ? 64 : 32;
  while (sub > 1 && b1t_smem<P>(m, bytes, sub) > room) --sub;
  return sub;
}

template <int P>
inline FwdLayout b1t_layout(int m, int bytes, long long n) {
  const long long tile = kMonoTeams * b1t_sub<P>(m, bytes);
  return FwdLayout((n + tile - 1) / tile, B1Tc<P>::MAP, B1Tc<P>::ST);
}

template <int P, typename S>
__global__ void __launch_bounds__(32 * kMonoTeams)
b1_tc_kernel(int m, long long n, FwdArgs<S> x, Acc* work, FwdLayout lay, int sub) {
  using Ric = typename B1Tc<P>::Ric;
  using Aff = typename B1Tc<P>::Aff;
  constexpr int H = P / 8, MAP = B1Tc<P>::MAP, ST = B1Tc<P>::ST, SCR = B1Tc<P>::SCR,
                TEAM = B1Tc<P>::TEAM;
  const int mm = m * m, T = kMonoTeams * sub, LD = T + 1, DS = m + 1;
  const int OQ = 1 + m, OA = 1 + 2 * m, OY = OA + mm, IN = OY + 1;
  const bool res = x.Fs != nullptr;
  __shared__ long long tile_of_block;
  Acc* lk = reinterpret_cast<Acc*>(qsl_smem);
  Acc* start = lk + 3 * MAP;
  Acc* ls = start + ST;
  Acc* teams = ls + ST;
  Acc* D = teams + kMonoTeams * TEAM;
  S* st = reinterpret_cast<S*>(D + T * DS);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, g = lane >> 2, tq = lane & 3;
  const auto buf = [&](int v, int k) { return teams + v * TEAM + k * MAP; };
  const auto scr = [&](int v) { return teams + v * TEAM + 3 * MAP; };
  Acc* const team_state = teams + w * TEAM + 3 * MAP + SCR;  // a team's state at its start

  if (t == 0) tile_of_block = atomicAdd(lay.chain.ticket(work), 1u);
  __syncthreads();
  const long long b = tile_of_block, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);

  for (int idx = t; idx < IN * cnt; idx += 32 * kMonoTeams) {
    const int c = idx / cnt, i = idx - c * cnt;
    const S* src = c == 0    ? x.d
                   : c < OQ  ? x.ps + (long long)(c - 1) * n
                   : c < OA  ? x.qs + (long long)(c - OQ) * n
                   : c < OY  ? x.as + (long long)(c - OA) * n
                             : x.y;
    cp_async_elem(st + c * LD + i, src + p0 + i);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int lo = w * sub, mine = max(0, min(sub, cnt - lo));
  Ric rop;
  rop.m = m;
  rop.cols = 1;

  // Phase A: the Riccati flow.
  {
    typename Ric::Run xr;
    Ric::identity(xr);
    for (int jj = 0; jj < mine; ++jj) {
      typename Ric::El e;
      rop.load(st, LD, lo + jj, e);
      Ric::fold(xr, e);
    }
    Ric::store(xr, buf(w, 0));
  }
  mono_team_scan(rop, buf, scr);
  mono_lookback(rop, b, lay.chain.nt, lay.chain.slots(work, 0, MAP), buf(kMonoTeams - 1, 0), lk,
                start, ls, buf, scr);
  __syncthreads();
  if (mine > 0) {
    mono_team_start(rop, buf, scr, start, team_state);
    typename Ric::State F;
    Ric::load_state(team_state, F);
    for (int jj = 0; jj < mine; ++jj) {
      const int pos = lo + jj;
      typename Ric::El e;
      rop.load(st, LD, pos, e);
      Acc ur[H], uc[H][2];
      const Acc c2 = Ric::emit(F.F, e, ur, uc), ic2 = Acc(1) / c2;
      if (res)  // B1r's F, the state before the element
#pragma unroll
        for (int k = 0; k < H; ++k)
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int jj2 = 0; jj2 < 2; ++jj2) {
              const int r = 8 * h + g, c = 8 * k + 2 * tq + jj2;
              if (r < m && c < m) x.Fs[(long long)(r * m + c) * n + p0 + pos] = S(F.F.v[k][h][jj2]);
            }
      Ric::step_f(F.F, e, ur, uc, ic2);
      if (tq == 0)
#pragma unroll
        for (int h = 0; h < H; ++h)
          if (8 * h + g < m) D[pos * DS + 8 * h + g] = ur[h] * ic2;
      if (lane == 0) D[pos * DS + m] = c2;
    }
  }
  __syncthreads();

  // Phase B: the whitening scan. The element at pos from its Riccati
  // element re (loaded): a - wd p^T, and wd y in column 0.
  Aff aop;
  aop.m = m;
  aop.cols = 1;
  const auto aff_element = [&](int pos, const typename Ric::El& re, typename Aff::El& e) {
    const Acc* dv = D + pos * DS;
    const Acc yv = Acc(st[OY * LD + pos]);
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int r = 8 * h + g;
        const Acc wr = r < m ? dv[r] : Acc(0);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) e.a.v[k][h][jj] = re.a.v[k][h][jj] - wr * re.pc[k][jj];
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 8 * k + 2 * tq + jj;
        e.bt.v[k][0][jj] = g == 0 && c < m ? dv[c] * yv : Acc(0);
      }
    }
  };
  {
    typename Aff::Run xr;
    Aff::identity(xr);
    for (int jj = 0; jj < mine; ++jj) {
      typename Ric::El re;
      rop.load(st, LD, lo + jj, re);
      typename Aff::El e;
      aff_element(lo + jj, re, e);
      Aff::fold(xr, e);
    }
    Aff::store(xr, buf(w, 0));
  }
  mono_team_scan(aop, buf, scr);
  mono_lookback(aop, b, lay.chain.nt, lay.chain.slots(work, 1, Aff::kMap), buf(kMonoTeams - 1, 0),
                lk, start, ls, buf, scr);
  __syncthreads();

  // Phase C: e from the team's start; the sums.
  Acc quad = Acc(0), logdet = Acc(0);
  if (mine > 0) {
    mono_team_start(aop, buf, scr, start, team_state);
    typename Aff::State es;
    Aff::load_state(team_state, es);
    for (int jj = 0; jj < mine; ++jj) {
      const int pos = lo + jj;
      typename Ric::El re;
      rop.load(st, LD, pos, re);
      typename Aff::El ae;
      aff_element(pos, re, ae);
      // p.e: e^T is row 0 of the state, on the lanes of quad 0.
      Acc pe = Acc(0);
      if (g == 0)
#pragma unroll
        for (int k = 0; k < H; ++k)
#pragma unroll
          for (int jj2 = 0; jj2 < 2; ++jj2) pe += es.s.v[k][0][jj2] * re.pc[k][jj2];
      pe += __shfl_xor_sync(0xffffffffu, pe, 1);
      pe += __shfl_xor_sync(0xffffffffu, pe, 2);
      pe = __shfl_sync(0xffffffffu, pe, 0);
      const Acc c = sqrt(D[pos * DS + m]);
      const Acc alpha = (Acc(st[OY * LD + pos]) - pe) / c;
      quad += alpha * alpha;
      logdet += log(c);
      if (res) {
        // Every lane has read the element: e and 1/c over its q and d.
        __syncwarp();
        if (g == 0)
#pragma unroll
          for (int k = 0; k < H; ++k)
#pragma unroll
            for (int jj2 = 0; jj2 < 2; ++jj2) {
              const int col = 8 * k + 2 * tq + jj2;
              if (col < m) st[(OQ + col) * LD + pos] = S(es.s.v[k][0][jj2]);
            }
        if (lane == 0) st[pos] = S(Acc(1) / c);
      }
      Aff::walk(es, ae);
    }
  }
  if (lane == 0) {
    ls[2 * w] = quad;
    ls[2 * w + 1] = logdet;
  }
  __syncthreads();
  if (res) {
    // [1/c | e] from the d and q rows.
    for (int idx = t; idx < (1 + m) * cnt; idx += 32 * kMonoTeams) {
      const int q = idx / cnt, i = idx - q * cnt;
      S* dst = q == 0 ? x.ics : x.es + (long long)(q - 1) * n;
      dst[p0 + i] = st[(q == 0 ? 0 : OQ + q - 1) * LD + i];
    }
  }
  Acc tile_quad = Acc(0), tile_logdet = Acc(0);
  if (t == 0)
    for (int v = 0; v < kMonoTeams; ++v) {
      tile_quad += ls[2 * v];
      tile_logdet += ls[2 * v + 1];
    }
  b1_finish(b, lay.chain.nt, tile_quad, tile_logdet, lay, work, lk, x.out);
}

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
// folds or applies them with the warp. Above m = 8 B2 runs b2_tc_kernel
// (below).

constexpr int kB2Teams = 4;      // warp teams per tile
constexpr int kB2GenWindow = 8;  // aggregates a look-back stages at once
constexpr int kB2WarpMaxM = 8;   // b2_warp_kernel's largest order

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
      g_combine<M>(tm, spec, 1, Q, win + l * MAP, Qn, tmp);
      Acc* swap = Q;
      Q = Qn;
      Qn = swap;
    }
  }
  tm.sync();
  if (end && more) {
    g_combine<M>(tm, spec, 1, Q, agg, GA, tmp);
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
                   scr);
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
  const GSpec aff_spec{gAff, M, M, 1}, cong_spec{gCong, M, M, 1};

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

// ------------------------------------- backward (B2) at m = 9..16: one launch
//
// b2_warp_kernel's design (tiles taken by a ticket over mirrored
// positions, staged once, each element's emissions computed once per tile,
// two scans and their look-backs, the cotangents formed in the tile) with
// maps padded to 16 x 16 and every m x m product on the float64 tensor
// cores (mma.sync m16n8k8), each team's running value in registers: B3's
// one-launch skeleton (quasisep_generic.cu: mono_tile) run over AffOp<16, 8>
// and then CongOp<16> (quasisep_tc.cuh) in one tile.
//
//   staging:   [y | ic | p | q | e | a | F] of each mirrored position, one
//              cp.async a value, component c at st[c * LD + i] (LD = T + 1,
//              odd, so that lanes reading different components of one
//              element hit different banks);
//   emissions: Fp, u, wd and six scalars, one thread an element;
//   phase A:   the affine adjoint, transitions A^T = a^T - p wd^T and loads
//              ebar = -alphabar ic p: each team folds its elements, the
//              teams' maps are scanned in the tile (mono_team_scan), the
//              grouped look-back (mono_lookback) gives the tile's start,
//              and each team walks its elements from its prefix, keeping
//              each element's mu (the state before it);
//   glue:      c2bar and Fpbar = -c2bar p - r ic^2 a^T mu, one thread an
//              element;
//   phase B:   the congruence adjoint, transitions A^T and loads
//              Fpbar p^T + p Fpbar^T: fold, in-tile scan and look-back as
//              in phase A. It scans S = Gbar + Gbar^T, the only form of
//              Gbar the cotangents read (phase C), and the scan is
//              linear in its loads, so S's loads are Gbar's symmetrized;
//   phase C:   each team walks S from its prefix and forms its elements'
//              cotangents, S a F on the tensor cores and the vectors as
//              dot products within a lane's quad, over the staged inputs;
//              the block writes them out.
//
// Each scan has its own chain in the workspace (ChainLayout, groups of
// kMonoGroup tiles), its merges and applications on the tensor cores (the
// whitening transitions do not need B3's compensated congruence look-back,
// quasisep_tc.cuh: CongOp). Every product runs in float64 whatever the storage
// type and the look-backs compose in one fixed order, so two launches on
// the same inputs agree bit for bit; cuda_loglik.plain_loglik_bwd_tiled
// is this association in plain PyTorch. What bounds it: bytes, as for
// b2_warp_kernel; the float64 tensor cores (about 8 m^3 multiply-adds an
// element) are far from binding. Shared memory bounds a tile: an element
// stages 2 m^2 + 3 m + 2 values (562 at m = 16) beside its emissions, so a
// tile holds 24 elements at m = 16 in float64 and 44 in float32, and its
// two look-backs and in-tile scans, a few microseconds each on one warp,
// are a larger share of it than at m = 8.

using B2Aff = AffOp<16, 8>;   // phase A: one column in a group of 8
using B2Cong = CongOp<16, false>;  // phase B: the plain look-back (see CongOp)
// Both scans' maps and states in the larger (the congruence's) slots.
constexpr int kB2TcMap = B2Cong::kMap, kB2TcState = B2Cong::kState;
constexpr int kB2TcTeam = 3 * kB2TcMap + B2Cong::kScratch + kB2TcState;
static_assert(B2Aff::kMap <= kB2TcMap && B2Aff::kState <= kB2TcState &&
                  B2Aff::kScratch <= B2Cong::kScratch,
              "the affine scan's values fit the congruence's slots");

// Shared memory of a block beside its tile, in bytes: the look-back's three
// maps, the tile's start and a state, and per team three maps, the merge's
// scratch and a state.
constexpr long long kB2TcFixed =
    (long long)(3 * kB2TcMap + 2 * kB2TcState + kMonoTeams * kB2TcTeam) * sizeof(Acc);

// Components staged an element, and its values kept in Acc:
// [Fp | u | wd | mu | Fpbar] and ic, ic^2, r, alpha, alphabar, k0, c2bar.
__host__ __device__ constexpr int b2t_in(int m) { return 2 + 3 * m + 2 * m * m; }
__host__ __device__ constexpr int b2t_emit(int m) { return 5 * m + 7; }

inline long long b2t_smem(int m, int bytes, int sub) {
  const long long tile = kMonoTeams * sub;
  return kB2TcFixed + tile * b2t_emit(m) * (long long)sizeof(Acc) +
         (long long)b2t_in(m) * (tile + 1) * bytes + 16;
}

// Elements per team: the most, up to 32, whose block fits 1 KB short of a
// block's shared memory. cuda_loglik._B2_SCHEDULE repeats it.
inline int b2t_sub(int m, int bytes) {
  int sub = 32;
  while (sub > 1 && b2t_smem(m, bytes, sub) > kGenSharedBlock - 1024) --sub;
  return sub;
}

// The workspace: two chains of look-back slots, the affine scan's and the
// congruence scan's.
inline ChainLayout b2t_layout(int m, int bytes, long long n) {
  const long long tile = kMonoTeams * b2t_sub(m, bytes);
  return ChainLayout((n + tile - 1) / tile, 2, kB2TcMap, kB2TcState, kMonoGroup);
}

template <typename S>
__global__ void __launch_bounds__(32 * kMonoTeams)
b2_tc_kernel(int m, long long n, BwdArgs<S> x, Acc* work, ChainLayout lay, int sub) {
  constexpr int P = 16, H = P / 8, MAP = kB2TcMap, ST = kB2TcState, TEAM = kB2TcTeam;
  const int mm = m * m, T = kMonoTeams * sub, LD = T + 1, DS = b2t_emit(m);
  // Staged components [y | ic | p | q | e | a | F] and outputs
  // [dbar | ybar | psbar | qsbar | asbar] (over the inputs, as in
  // b2_warp_kernel).
  const int OP = 2, OQ = 2 + m, OE = 2 + 2 * m, OA = 2 + 3 * m, OF = OA + mm, IN = OF + mm,
            OUT = 2 + 2 * m + mm;
  // An element's kept values at D[pos * DS]: [Fp | u | wd | mu | Fpbar |
  // ic, ic^2, r, alpha, alphabar, k0, c2bar], k0 = -lbar / ic + alphabar
  // alpha / ic (the part of icbar without mu).
  const int DU = m, DW = 2 * m, DMU = 3 * m, DFB = 4 * m, DSC = 5 * m;
  __shared__ long long tile_of_block;
  Acc* lk = reinterpret_cast<Acc*>(qsl_smem);
  Acc* start = lk + 3 * MAP;
  Acc* ls = start + ST;
  Acc* teams = ls + ST;
  Acc* D = teams + kMonoTeams * TEAM;
  S* st = reinterpret_cast<S*>(D + T * DS);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, g = lane >> 2, tq = lane & 3;
  const auto buf = [&](int v, int k) { return teams + v * TEAM + k * MAP; };
  const auto scr = [&](int v) { return teams + v * TEAM + 3 * MAP; };
  Acc* const mine_state = teams + w * TEAM + 3 * MAP + B2Cong::kScratch;

  if (t == 0) tile_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  const long long b = tile_of_block, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);

  // Stage the tile: position i (element n - 1 - p0 - i) of component c at
  // st[c * LD + i].
  for (int idx = t; idx < IN * cnt; idx += 32 * kMonoTeams) {
    const int c = idx / cnt, i = idx - c * cnt;
    const S* src = c == 0    ? x.y
                   : c == 1  ? x.ics
                   : c < OQ  ? x.ps + (long long)(c - OP) * n
                   : c < OE  ? x.qs + (long long)(c - OQ) * n
                   : c < OA  ? x.es + (long long)(c - OE) * n
                   : c < OF  ? x.as + (long long)(c - OA) * n
                             : x.Fs + (long long)(c - OF) * n;
    cp_async_elem(st + c * LD + i, src + (n - 1 - p0 - i));
  }
  cp_async_commit();
  const Acc qb = Acc(*x.qbar), lb = Acc(*x.lbar);
  cp_async_wait_all();
  __syncthreads();
  const auto in = [&](int c, int pos) { return Acc(st[c * LD + pos]); };
  const auto Dv = [&](int pos, int c) { return D[pos * DS + c]; };

  // Each element's emissions, one thread an element.
  for (int pos = t; pos < cnt; pos += 32 * kMonoTeams) {
    Acc* d = D + pos * DS;
    Acc p[P];
#pragma unroll
    for (int i = 0; i < P; ++i) p[i] = i < m ? in(OP + i, pos) : Acc(0);
    const Acc ic = in(1, pos), ic2 = ic * ic;
    Acc pe = Acc(0);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i >= m) break;
      Acc acc = Acc(0);
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (j < m) acc += in(OF + i * m + j, pos) * p[j];
      d[i] = acc;
      pe += p[i] * in(OE + i, pos);
    }
    for (int i = 0; i < m; ++i) {
      Acc acc = in(OQ + i, pos);
      for (int j = 0; j < m; ++j) acc -= in(OA + i * m + j, pos) * d[j];
      d[DU + i] = acc;
      d[DW + i] = acc * ic2;
    }
    const Acc r = in(0, pos) - pe, alpha = r * ic, alphabar = Acc(2) * qb * alpha;
    d[DSC] = ic;
    d[DSC + 1] = ic2;
    d[DSC + 2] = r;
    d[DSC + 3] = alpha;
    d[DSC + 4] = alphabar;
    d[DSC + 5] = -lb / ic + alphabar * alpha / ic;
  }
  __syncthreads();

  // The element's transition A^T (i, l) = a (l, i) - wd_l p_i, padded, in
  // the lane's entries.
  const auto transition = [&](int pos, Frag<P, P>& E) {
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * tq + jj;
          E.v[k][h][jj] = r < m && c < m
                              ? in(OA + c * m + r, pos) - Dv(pos, DW + c) * in(OP + r, pos)
                              : Acc(0);
        }
  };
  const int lo = w * sub, mine = max(0, min(sub, cnt - lo));

  // Phase A: the affine adjoint (A^T, ebar); its loads are column 0 of
  // the group of 8 (B2Aff's b^T, row 0).
  B2Aff aop;
  aop.m = m;
  aop.cols = 1;
  const auto aff_element = [&](int pos, B2Aff::El& e) {
    transition(pos, e.a);
    const Acc f = -(Dv(pos, DSC + 4) * Dv(pos, DSC));
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 8 * k + 2 * tq + jj;
        e.bt.v[k][0][jj] = g == 0 && c < m ? f * in(OP + c, pos) : Acc(0);
      }
  };
  {
    B2Aff::Run xr;
    B2Aff::identity(xr);
    for (int jj = 0; jj < mine; ++jj) {
      B2Aff::El e;
      aff_element(lo + jj, e);
      B2Aff::fold(xr, e);
    }
    B2Aff::store(xr, buf(w, 0));
  }
  mono_team_scan(aop, buf, scr);
  mono_lookback(aop, b, lay.nt, lay.slots(work, 0, B2Aff::kMap), buf(kMonoTeams - 1, 0), lk,
                start, ls, buf, scr);
  __syncthreads();
  if (mine > 0) {
    mono_team_start(aop, buf, scr, start, mine_state);
    B2Aff::State s;
    B2Aff::load_state(mine_state, s);
    for (int jj = 0; jj < mine; ++jj) {
      const int pos = lo + jj;
      B2Aff::El e;
      aff_element(pos, e);
      if (g == 0)
#pragma unroll
        for (int k = 0; k < H; ++k)
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2) {
            const int c = 8 * k + 2 * tq + j2;
            if (c < m) D[pos * DS + DMU + c] = s.s.v[k][0][j2];
          }
      B2Aff::walk(s, e);
    }
  }
  __syncthreads();

  // The glue from mu: c2bar and Fpbar, one thread an element.
  for (int pos = t; pos < cnt; pos += 32 * kMonoTeams) {
    Acc* d = D + pos * DS;
    const Acc ic = d[DSC], ic2 = d[DSC + 1], r = d[DSC + 2];
    Acc uw = Acc(0);
    for (int i = 0; i < m; ++i) uw += d[DU + i] * (d[DMU + i] * r);
    const Acc c2bar = Acc(-0.5) * (d[DSC + 5] + Acc(2) * ic * uw) * ic * ic2;
    d[DSC + 6] = c2bar;
    for (int j = 0; j < m; ++j) {
      Acc acc = -c2bar * in(OP + j, pos);
      for (int i = 0; i < m; ++i) acc -= in(OA + i * m + j, pos) * (d[DMU + i] * r * ic2);
      d[DFB + j] = acc;
    }
  }
  __syncthreads();

  // Phase B: the congruence adjoint (A^T, Fpbar p^T + p Fpbar^T).
  B2Cong cop;
  cop.m = m;
  const auto cong_element = [&](int pos, B2Cong::El& e) {
    transition(pos, e.a);
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * tq + jj;
          e.b.v[k][h][jj] = r < m && c < m ? Dv(pos, DFB + r) * in(OP + c, pos) +
                                                 in(OP + r, pos) * Dv(pos, DFB + c)
                                           : Acc(0);
        }
  };
  {
    B2Cong::Run xr;
    B2Cong::identity(xr);
    for (int jj = 0; jj < mine; ++jj) {
      B2Cong::El e;
      cong_element(lo + jj, e);
      B2Cong::fold(xr, e);
    }
    B2Cong::store(xr, buf(w, 0));
  }
  mono_team_scan(cop, buf, scr);
  mono_lookback(cop, b, lay.nt, lay.slots(work, 1, B2Cong::kMap), buf(kMonoTeams - 1, 0), lk,
                start, ls, buf, scr);
  __syncthreads();

  // Phase C: each team walks S from its prefix; the cotangents over the
  // inputs. Vectors at the lane's rows (v[h] = v_{8 h + g}, the same on a
  // quad's lanes) or columns (v[k][j] = v_{8 k + 2 tq + j}).
  if (mine > 0) {
    mono_team_start(cop, buf, scr, start, mine_state);
    B2Cong::State sS;
    B2Cong::load_state(mine_state, sS);
    for (int jj = 0; jj < mine; ++jj) {
      const int pos = lo + jj;
      const Acc* d = D + pos * DS;
      const Acc ic = d[DSC], ic2 = d[DSC + 1], r = d[DSC + 2], alphabar = d[DSC + 4],
                c2bar = d[DSC + 6], ic4 = ic2 * ic2;
      Acc ur[H], mur[H], wr[H], er[H], fpr[H], fbr[H], pr[H];
      Acc uc[H][2], ec[H][2], fpc[H][2], fbc[H][2], pc[H][2];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int i = 8 * h + g;
        const bool ok = i < m;
        ur[h] = ok ? d[DU + i] : Acc(0);
        mur[h] = ok ? d[DMU + i] : Acc(0);
        wr[h] = ok ? d[DW + i] : Acc(0);
        fpr[h] = ok ? d[i] : Acc(0);
        fbr[h] = ok ? d[DFB + i] : Acc(0);
        er[h] = ok ? in(OE + i, pos) : Acc(0);
        pr[h] = ok ? in(OP + i, pos) : Acc(0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * h + 2 * tq + j;
          const bool okc = c < m;
          uc[h][j] = okc ? d[DU + c] : Acc(0);
          fpc[h][j] = okc ? d[c] : Acc(0);
          fbc[h][j] = okc ? d[DFB + c] : Acc(0);
          ec[h][j] = okc ? in(OE + c, pos) : Acc(0);
          pc[h][j] = okc ? in(OP + c, pos) : Acc(0);
        }
      }
      // a^T and F^T, F in the lane's entries.
      Frag<P, P> aT, FT, Fm;
#pragma unroll
      for (int k = 0; k < H; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = 8 * h + g, c = 8 * k + 2 * tq + j;
            const bool ok = i < m && c < m;
            aT.v[k][h][j] = ok ? in(OA + c * m + i, pos) : Acc(0);
            FT.v[k][h][j] = ok ? in(OF + c * m + i, pos) : Acc(0);
            Fm.v[k][h][j] = ok ? in(OF + i * m + c, pos) : Acc(0);
          }
      // Su = S u, u^T S u, wd^T mu, a^T Su, F^T Fpbar, F a^T Su.
      Acc Su[H], Suc[H][2], aTSu[H], aTSuc[H][2], FTfb[H], FaTSu[H];
      rowdot(sS.g, uc, Su);
      const Acc uSu = row_sum<P>(ur, Su), wmu = row_sum<P>(wr, mur);
      to_cols<P>(Su, Suc);
      rowdot(aT, Suc, aTSu);
      to_cols<P>(aTSu, aTSuc);
      rowdot(FT, fbc, FTfb);
      rowdot(Fm, aTSuc, FaTSu);
      // asbar = S a F + mu (e - r ic^2 Fp)^T - ic^2 Su Fp^T.
      Frag<P, P> Sa, asb;
      xzt(sS.g, aT, Sa);
      xzt(Sa, FT, asb);
#pragma unroll
      for (int k = 0; k < H; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            asb.v[k][h][j] += mur[h] * (ec[k][j] - r * ic2 * fpc[k][j]) - ic2 * Su[h] * fpc[k][j];
      Acc psb[H], qsb[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        psb[h] = -(alphabar * ic + wmu) * er[h] - c2bar * fpr[h] + uSu * ic4 * fpr[h] + FTfb[h] -
                 ic2 * FaTSu[h];
        qsb[h] = (mur[h] * r + Su[h]) * ic2;
      }
      const Acc o_d = c2bar - Acc(0.5) * uSu * ic4, o_y = alphabar * ic + wmu;
      // S's step over the element.
      {
        B2Cong::El e;
        transition(pos, e.a);
#pragma unroll
        for (int k = 0; k < H; ++k)
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) e.b.v[k][h][j] = fbr[h] * pc[k][j] + pr[h] * fbc[k][j];
        B2Cong::walk(sS, e);
      }
      __syncwarp();
      // Every read of the element's inputs is done: its outputs go over them.
#pragma unroll
      for (int k = 0; k < H; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = 8 * h + g, c = 8 * k + 2 * tq + j;
            if (i < m && c < m) st[(2 + 2 * m + i * m + c) * LD + pos] = S(asb.v[k][h][j]);
          }
      if (tq == 0)
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int i = 8 * h + g;
          if (i < m) {
            st[(OP + i) * LD + pos] = S(psb[h]);
            st[(OQ + i) * LD + pos] = S(qsb[h]);
          }
        }
      if (lane == 0) {
        st[pos] = S(o_d);
        st[LD + pos] = S(o_y);
      }
    }
  }
  __syncthreads();
  for (int idx = t; idx < OUT * cnt; idx += 32 * kMonoTeams) {
    const int c = idx / cnt, i = idx - c * cnt;
    S* dst = c == 0           ? x.dbar
             : c == 1         ? x.ybar
             : c < 2 + m      ? x.psbar + (long long)(c - 2) * n
             : c < 2 + 2 * m  ? x.qsbar + (long long)(c - 2 - m) * n
                              : x.asbar + (long long)(c - 2 - 2 * m) * n;
    dst[n - 1 - p0 - i] = st[c * LD + i];
  }
}

// ---------------------------------------------------------------- dispatch

constexpr int kB1MaxM = 16;  // this library's largest order (quasisep_loglik_wide.cu above)

bool order_ok(int m, long long n) { return m > 4 && m <= kB1MaxM && n >= 1; }

// Workspaces: the larger of the two storage types' (their tiles differ).
long long fwd_workspace(int m, long long n) {
  long long f32, f64;
  if (m <= 8) {
    f32 = b1t_layout<8>(m, 4, n).total;
    f64 = b1t_layout<8>(m, 8, n).total;
  } else {
    f32 = b1t_layout<16>(m, 4, n).total;
    f64 = b1t_layout<16>(m, 8, n).total;
  }
  return f32 > f64 ? f32 : f64;
}

long long bwd_workspace(int m, long long n) {
  const long long f32 = m > kB2WarpMaxM ? b2t_layout(m, 4, n).total : b2g_layout(m, 4, n).total;
  const long long f64 = m > kB2WarpMaxM ? b2t_layout(m, 8, n).total : b2g_layout(m, 8, n).total;
  return f32 > f64 ? f32 : f64;
}

// B1 or B1r: one memset (the ticket, the flags, the finish ticket) and one
// launch.
template <int P, typename S>
cudaError_t run_b1_tc(int m, long long n, const FwdArgs<S>& x, Acc* work, cudaStream_t st) {
  const int sub = b1t_sub<P>(m, sizeof(S));
  const FwdLayout L = b1t_layout<P>(m, sizeof(S), n);
  if (L.chain.nt > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(work + L.chain.flags, 0, L.zero_bytes(), st);
  if (e != cudaSuccess) return e;
  return g_launch(b1_tc_kernel<P, S>, dim3((unsigned)L.chain.nt), 32 * kMonoTeams,
                  b1t_smem<P>(m, sizeof(S), sub), st, m, n, x, work, L, sub);
}

template <typename S>
int loglik(int m, long long n, const FwdArgs<S>& x, Acc* work, long long work_elems,
           void* stream) {
  if (!order_ok(m, n) || work_elems < fwd_workspace(m, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(m <= 8 ? run_b1_tc<8, S>(m, n, x, work, st) : run_b1_tc<16, S>(m, n, x, work, st));
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

// At m = 9..16: one memset (the ticket and the flags) and one launch.
template <typename S>
cudaError_t run_b2_tc(int m, long long n, const BwdArgs<S>& x, Acc* work, cudaStream_t st) {
  const int sub = b2t_sub(m, sizeof(S));
  const ChainLayout L = b2t_layout(m, sizeof(S), n);
  if (L.nt > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(work + L.flags, 0, L.flag_words * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  return g_launch(b2_tc_kernel<S>, dim3((unsigned)L.nt), 32 * kMonoTeams,
                  b2t_smem(m, sizeof(S), sub), st, m, n, x, work, L, sub);
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
  return (int)run_b2_tc<S>(m, n, x, work, st);
}

}  // namespace

extern "C" {

// Workspaces, in float64 elements; -1 for an order this library does not
// take (it takes 4 < m <= 16).
long long qsl_workspace_elems(int m, int n) {
  return order_ok(m, n) ? fwd_workspace(m, n) : -1;
}

long long qsl_bwd_workspace_elems(int m, int n) {
  return order_ok(m, n) ? bwd_workspace(m, n) : -1;
}

// B1 and B1r's association for operands of `bytes` bytes: elements per tile
// and per team (one warp) into tile[0], sub[0]; returns 0, or -1 for an
// order this library does not take.
int qsl_fwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (!order_ok(m, 1) || (bytes != 4 && bytes != 8)) return -1;
  *sub = m <= 8 ? b1t_sub<8>(m, bytes) : b1t_sub<16>(m, bytes);
  *tile = kMonoTeams * *sub;
  return 0;
}

// B2's association for operands of `bytes` bytes: elements per tile and
// per team (one warp) into tile[0], sub[0]; returns 0, or -1 for an order
// this library does not take.
int qsl_bwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (!order_ok(m, 1) || (bytes != 4 && bytes != 8)) return -1;
  *sub = m > kB2WarpMaxM ? b2t_sub(m, bytes) : b2g_sub(m, bytes);
  *tile = kB2Teams * *sub;
  return 0;
}

// B1: (quad, logdet) into out[0], out[1].
int qsl_loglik_f32(int m, int n, const float* d, const float* ps,
                   const float* qs, const float* as, const float* y,
                   float* out, double* work, long long work_elems,
                   void* stream) {
  const FwdArgs<float> x{d, ps, qs, as, y, out, nullptr, nullptr, nullptr};
  return loglik<float>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_f64(int m, int n, const double* d, const double* ps,
                   const double* qs, const double* as, const double* y,
                   double* out, double* work, long long work_elems,
                   void* stream) {
  const FwdArgs<double> x{d, ps, qs, as, y, out, nullptr, nullptr, nullptr};
  return loglik<double>(m, n, x, work, work_elems, stream);
}

// B1r: as B1, and the residuals F (m*m, n), e (m, n) and 1/c (n).
int qsl_loglik_res_f32(int m, int n, const float* d, const float* ps,
                       const float* qs, const float* as, const float* y,
                       float* out, float* Fs, float* es, float* ics,
                       double* work, long long work_elems, void* stream) {
  const FwdArgs<float> x{d, ps, qs, as, y, out, Fs, es, ics};
  return loglik<float>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_res_f64(int m, int n, const double* d, const double* ps,
                       const double* qs, const double* as, const double* y,
                       double* out, double* Fs, double* es, double* ics,
                       double* work, long long work_elems, void* stream) {
  const FwdArgs<double> x{d, ps, qs, as, y, out, Fs, es, ics};
  return loglik<double>(m, n, x, work, work_elems, stream);
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
