// Kernels B1, B1r and B2 above m = 16 on Hopper (sm_90a).
//
// Replaces, for 16 < m <= 32, the TPU kernels of
// tinygp_tpu/solvers/quasisep/pallas_loglik.py: _loglik_kernel (line 86)
// with residuals=False (B1) and residuals=True (B1r), and _bwd_kernel
// (line 414, B2). The C interface is quasisep_loglik_generic.cu's, symbol
// for symbol (a library of its own, so that the two build at once); above
// 32 the wrapper raises (ROADMAP N10).
//
// At these orders neither a warp's registers nor four teams' maps hold a
// monoid value, so each kernel runs quasisep_wide.cu's skeleton
// (quasisep_wide.cuh): a tile taken by a ticket, a team the whole block,
// each product of maps padded to P = 24 or 32 shared by its four warps on
// the float64 tensor cores (BlockMM), the elements streamed through shared
// memory in chunks with cp.async (16 bytes a copy where the operands'
// alignment allows) and put into an element map in turn, the grouped
// look-back by the block (wide_lookback), each chain of tiles its own.
// Both kernels run two scans in one tile, as their tensor-core
// counterparts up to m = 16 do:
//
//   b1_wide_kernel (B1, B1r; tiles of kB1WideTile elements):
//     phase A: the Riccati flow, folded with the rank-one step
//              (RicOp::fold_map); after the look-back the walk keeps each
//              element's c2 = d - p^T F p and wd = (q - a F p) / c2 in
//              shared memory (D) and, for B1r, writes each F;
//     phase B: the whitening scan e' = (a - wd p^T) e + wd y (AffOp's
//              column 0), its element maps formed from the streamed a, p,
//              y and D: fold, look-back;
//     phase C: the walk of e: alpha = (y - p.e) / c summed in element
//              order with log c (thread 0), B1r writing e and 1/c; the
//              last tile to finish sums every tile's sums in tile order
//              (quasisep_tc.cuh: b1_finish).
//   b2_wide_kernel (B2; tiles of kB2WideTile mirrored positions):
//     phase A: each element's emissions (Fp, u, wd and the scalars) into
//              D, and the affine adjoint (A^T, ebar) folded and looked
//              back;
//     phase B: the walk of mu (the map applied by the block's threads, a
//              row each), the glue c2bar and Fpbar, and the congruence
//              adjoint (A^T, Fpbar p^T + p Fpbar^T) folded in the same
//              pass and looked back: it scans S = Gbar + Gbar^T
//              (quasisep_loglik_generic.cu: b2_tc_kernel);
//     phase C: the walk of S and each element's cotangents, S a F by two
//              of the block's products, the vectors by its threads.
//
// Every product runs in float64 whatever the storage type, and the
// look-backs compose in one fixed order, so two launches on the same inputs
// agree bit for bit; cuda_loglik.plain_loglik_terms_res_tiled and
// plain_loglik_bwd_tiled are these associations (a tile one team) in plain
// PyTorch. What bounds them: bytes (B1 reads m^2 + 2m + 2 values an
// element, B1r writes m^2 + m + 1; B2 reads 2m^2 + 3m + 2 and writes
// m^2 + 2m + 2), and near them at P = 32 the float64 tensor cores. The cost
// against the bound is a block's latency through each element's products,
// barriers and staging, one block a multiprocessor (PERF.md).

#include "quasisep_wide.cuh"

namespace {

constexpr int kLoglikWideMinM = 17, kLoglikWideMaxM = 32;
constexpr int kB1WideTile = 64;  // the Riccati flow's look-back pays inverses: long tiles
constexpr int kB2WideTile = 32;

// A tile's elements streamed through shared memory in chunks of E (as
// quasisep_wide.cu's wide_tile streams them), by every thread of the
// block: component c of the chunk's position e at raw[c E + e] in the
// operands' memory order, so reversed where the positions mirror the
// elements (position i is element n - 1 - p0 - i). src(c) is component c's
// row. A full chunk moves 16 bytes a copy where every row allows it.
template <typename S, int E, class Src>
struct WideStream {
  static constexpr int V = E * (int)sizeof(S) / 16, W = 16 / (int)sizeof(S), LE = wide_log2(E);
  S* raw;
  Src src;
  long long n, p0;
  int cnt, comps;
  bool reverse, by16;

  // The chunk of positions [k E, k E + E) into raw.
  __device__ void fetch(int k) const {
    const int e0 = k * E, t = threadIdx.x;
    if (by16 && e0 + E <= cnt) {
      constexpr int VV = V > 0 ? V : 1;
      const long long lo = reverse ? n - p0 - e0 - E : p0 + e0;
      for (int idx = t; idx < comps * VV; idx += kWideThreads) {
        const int c = idx / VV, v = idx - c * VV;
        cp_async16(raw + c * E + v * W, src(c) + lo + v * W);
      }
    } else {
      for (int idx = t; idx < comps * E; idx += kWideThreads) {
        const int c = idx >> LE, e = idx & (E - 1);
        if (e0 + e < cnt)
          cp_async_elem(raw + c * E + (reverse ? E - 1 - e : e),
                        src(c) + (reverse ? n - 1 - p0 - e0 - e : p0 + e0 + e));
      }
    }
    cp_async_commit();
  }
  // Position jj's component c, once its chunk has arrived.
  __device__ Acc val(int c, int jj) const {
    const int e = jj & (E - 1);
    return Acc(raw[c * E + (reverse ? E - 1 - e : e)]);
  }
  // Before position jj's values are read: its chunk has arrived.
  __device__ void arrive(int jj) const {
    if ((jj & (E - 1)) == 0) {
      cp_async_wait_all();
      __syncthreads();
    }
  }
  // After every read of position jj's values (and a barrier): the next
  // chunk, once this one is used up.
  __device__ void next(int jj) const {
    if ((jj & (E - 1)) == E - 1 && jj + 1 < cnt) fetch((jj + 1) >> LE);
  }
};

// By every thread of the block: size values of p set to 0.
__device__ void wide_zero(Acc* p, int size) {
  for (int c = threadIdx.x; c < size; c += kWideThreads) p[c] = Acc(0);
  __syncthreads();
}

// ------------------------------------------------------------ forward (B1)

// Shared memory of a B1 block (offsets in Acc): the fold's three maps, the
// streamed chunk's region (its first two maps the look-back's maps 3 and
// 4), the merges' scratch, two states, the Riccati step's vectors, then D
// (kB1WideTile rows of P + 1: wd and c2).
template <int P, typename S>
struct B1WideSmem {
  using Ric = RicOp<P, BlockMM>;
  using Aff = AffOp<P, 8, BlockMM>;
  static_assert(Aff::kMap <= Ric::kMap && Aff::kState <= Ric::kState,
                "the whitening scan's maps and states fit the Riccati flow's");
  static constexpr int kMaxIn = 2 + 2 * P + P * P;  // [d | p | q | a | y]
  static constexpr int DS = P + 1;
  static constexpr long long kMapBytes = (long long)Ric::kMap * sizeof(Acc);
  static constexpr long long kFixed =
      (long long)(3 * Ric::kMap + Ric::kScratch + 2 * Ric::kState + 4 * P + 4 + kB1WideTile * DS) *
      sizeof(Acc);
  static constexpr long long kPer = (long long)kMaxIn * sizeof(S);
  static constexpr int kChunk = wide_chunk(kFixed, kPer, kMapBytes, 128 / (int)sizeof(S));
  static constexpr long long kRegion = wide_region(kPer, kMapBytes, kChunk);
  static constexpr int kScr = (int)((3 * kMapBytes + kRegion) / sizeof(Acc)),
                       kSt = kScr + Ric::kScratch, kS = kSt + Ric::kState, kVec = kS + Ric::kState,
                       kD = kVec + 4 * P + 4;
  static constexpr long long kBytes = kFixed + kRegion;
  static_assert(kBytes <= kGenSharedBlock, "a block's shared memory");
};

template <int P, typename S>
__global__ void __launch_bounds__(kWideThreads)
b1_wide_kernel(int m, long long n, FwdArgs<S> x, Acc* work, FwdLayout lay) {
  using L = B1WideSmem<P, S>;
  using Ric = typename L::Ric;
  using Aff = typename L::Aff;
  constexpr int T = kB1WideTile, DS = L::DS;
  constexpr int ALM = Aff::LM, ALS = Aff::LS, RLS = Ric::LS;
  const int mm = m * m, t = threadIdx.x;
  const int OQ = 1 + m, OA = 1 + 2 * m, OY = OA + mm, IN = OY + 1;
  const bool res = x.Fs != nullptr;
  __shared__ long long ticket_of_block;
  Acc* maps = reinterpret_cast<Acc*>(qsl_smem);
  Acc* scr = maps + L::kScr;
  Acc* st = maps + L::kSt;
  Acc* s = maps + L::kS;
  Acc* vec = maps + L::kVec;
  Acc* D = maps + L::kD;
  S* raw = reinterpret_cast<S*>(maps + 3 * Ric::kMap);  // the streamed chunk (WideStream)

  if (t == 0) ticket_of_block = atomicAdd(lay.chain.ticket(work), 1u);
  __syncthreads();
  const long long b = ticket_of_block, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);
  Ric rop;
  rop.m = m;
  rop.cols = 1;
  Aff aop;
  aop.m = m;
  aop.cols = 1;

  const auto src_of = [&](int c) {
    return c == 0    ? x.d
           : c < OQ  ? x.ps + (long long)(c - 1) * n
           : c < OA  ? x.qs + (long long)(c - OQ) * n
           : c < OY  ? x.as + (long long)(c - OA) * n
                     : x.y;
  };
  const WideStream<S, L::kChunk, decltype(src_of)> io{
      raw, src_of, n, p0, cnt, IN, false,
      L::kChunk * sizeof(S) >= 16 && (n * (long long)sizeof(S)) % 16 == 0 && aligned16(x.d) &&
          aligned16(x.ps) && aligned16(x.qs) && aligned16(x.as) && aligned16(x.y)};
  const auto val = [&](int c, int jj) { return io.val(c, jj); };
  // Element jj's Riccati element map (el_slot's places; its padding 0).
  const auto stage_ric = [&](Acc* el, int jj) {
    io.arrive(jj);
    for (int c = t; c < OY; c += kWideThreads) el[rop.el_slot(c)] = val(c, jj);
    __syncthreads();
    io.next(jj);
  };
  // Element jj's whitening map [a - wd p^T | wd y] (its padding 0), and p,
  // y into pv[0..m), pv[P].
  const auto stage_aff = [&](Acc* el, int jj, Acc* pv) {
    io.arrive(jj);
    const Acc* dv = D + jj * DS;
    const Acc yv = val(OY, jj);
    for (int idx = t; idx < mm; idx += kWideThreads) {
      const int r = idx / m, c = idx - r * m;
      el[r * ALM + c] = val(OA + idx, jj) - dv[r] * val(1 + c, jj);
    }
    for (int r = t; r < m; r += kWideThreads) {
      el[r * ALM + P] = dv[r] * yv;
      if (pv) pv[r] = val(1 + r, jj);
    }
    if (pv && t == 0) pv[P] = yv;
    __syncthreads();
    io.next(jj);
  };

  // Phase A: the Riccati flow (maps 0 and 1 the running map, 2 the element).
  int cur = 0, nxt = 1;
  Acc* el = maps + 2 * Ric::kMap;
  wide_zero(el, Ric::kMap);
  Ric::identity_map(maps);
  io.fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    stage_ric(el, jj);
    w_fold(rop, maps + cur * Ric::kMap, el, maps + nxt * Ric::kMap, scr, vec);
    const int sw = cur;
    cur = nxt;
    nxt = sw;
  }
  wide_lookback(rop, b, lay.chain.nt, lay.chain.slots(work, 0, Ric::kMap), maps, cur, scr, st, s);
  el = maps + nxt * Ric::kMap;
  wide_zero(el, Ric::kMap);
  io.fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    stage_ric(el, jj);
    if (res)
      for (int q = t; q < mm; q += kWideThreads)
        x.Fs[(long long)q * n + p0 + jj] = S(st[(q / m) * RLS + q % m]);
    w_walk(rop, st, el, scr, vec);
    // vec: u at [2P, 3P), 1 / c2 at 3P, c2 at 3P + 1 (RicOp::emit_map).
    for (int i = t; i < m; i += kWideThreads) D[jj * DS + i] = vec[2 * P + i] * vec[3 * P];
    if (t == 0) D[jj * DS + m] = vec[3 * P + 1];
  }
  __syncthreads();

  // Phase B: the whitening scan (maps of Aff's size: 0 and 1 the running
  // map, 2 the element).
  cur = 0;
  nxt = 1;
  el = maps + 2 * Aff::kMap;
  wide_zero(el, Aff::kMap);
  Aff::identity_map(maps);
  io.fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    stage_aff(el, jj, nullptr);
    w_fold(aop, maps + cur * Aff::kMap, el, maps + nxt * Aff::kMap, scr, vec);
    const int sw = cur;
    cur = nxt;
    nxt = sw;
  }
  wide_lookback(aop, b, lay.chain.nt, lay.chain.slots(work, 1, Aff::kMap), maps, cur, scr, st, s);

  // Phase C: the walk of e (column 0 of the state), alpha and the sums.
  el = maps + nxt * Aff::kMap;
  wide_zero(el, Aff::kMap);
  io.fetch(0);
  Acc quad = Acc(0), logdet = Acc(0);
  for (int jj = 0; jj < cnt; ++jj) {
    stage_aff(el, jj, vec);
    const Acc c = sqrt(D[jj * DS + m]);
    if (t == 0) {
      Acc pe = Acc(0);
      for (int i = 0; i < m; ++i) pe += vec[i] * st[i * ALS];
      const Acc alpha = (vec[P] - pe) / c;
      quad += alpha * alpha;
      logdet += log(c);
    }
    if (res) {
      for (int i = t; i < m; i += kWideThreads) x.es[(long long)i * n + p0 + jj] = S(st[i * ALS]);
      if (t == 0) x.ics[p0 + jj] = S(Acc(1) / c);
    }
    w_walk(aop, st, el, scr, vec);
  }
  __syncthreads();
  b1_finish(b, lay.chain.nt, quad, logdet, lay, work, maps, x.out);
}

// ------------------------------------------------------------ backward (B2)

// Shared memory of a B2 block (offsets in Acc): the fold's three maps (the
// congruence's size), the streamed chunk's region, the scratch, two
// states, four vectors, then D (kB2WideTile rows of DS: Fp, u, wd, mu,
// Fpbar at P apart, then ic, ic^2, r, alpha, alphabar, k0, c2bar).
template <int P, typename S>
struct B2WideSmem {
  using Cong = CongOp<P, false, BlockMM>;
  using Aff = AffOp<P, 8, BlockMM>;
  static_assert(Aff::kMap <= Cong::kMap && Aff::kState <= Cong::kState,
                "the affine adjoint's maps and states fit the congruence's");
  static constexpr int kMaxIn = 2 + 3 * P + 2 * P * P;  // [y | ic | p | q | e | a | F]
  static constexpr int DS = 5 * P + 7;
  static constexpr long long kMapBytes = (long long)Cong::kMap * sizeof(Acc);
  static constexpr long long kFixed =
      (long long)(3 * Cong::kMap + Cong::kScratch + 2 * Cong::kState + 4 * P + 4 +
                  kB2WideTile * DS) *
      sizeof(Acc);
  static constexpr long long kPer = (long long)kMaxIn * sizeof(S);
  static constexpr int kChunk = wide_chunk(kFixed, kPer, kMapBytes, 128 / (int)sizeof(S));
  static constexpr long long kRegion = wide_region(kPer, kMapBytes, kChunk);
  static constexpr int kScr = (int)((3 * kMapBytes + kRegion) / sizeof(Acc)),
                       kSt = kScr + Cong::kScratch, kS = kSt + Cong::kState,
                       kVec = kS + Cong::kState, kD = kVec + 4 * P + 4;
  static constexpr long long kBytes = kFixed + kRegion;
  static_assert(kBytes <= kGenSharedBlock, "a block's shared memory");
};

template <int P, typename S>
__global__ void __launch_bounds__(kWideThreads)
b2_wide_kernel(int m, long long n, BwdArgs<S> x, Acc* work, ChainLayout lay) {
  using L = B2WideSmem<P, S>;
  using Cong = typename L::Cong;
  using Aff = typename L::Aff;
  constexpr int T = kB2WideTile, DS = L::DS;
  constexpr int ALM = Aff::LM, ALS = Aff::LS, CLM = Cong::LM, CLS = Cong::LS;
  constexpr int DFP = 0, DU = P, DW = 2 * P, DMU = 3 * P, DFB = 4 * P, DSC = 5 * P;
  const int mm = m * m, t = threadIdx.x;
  const int OP = 2, OQ = 2 + m, OE = 2 + 2 * m, OA = 2 + 3 * m, OF = OA + mm, IN = OF + mm;
  __shared__ long long ticket_of_block;
  Acc* maps = reinterpret_cast<Acc*>(qsl_smem);
  Acc* scr = maps + L::kScr;
  Acc* st = maps + L::kSt;
  Acc* s = maps + L::kS;
  Acc* vec = maps + L::kVec;
  Acc* D = maps + L::kD;
  S* raw = reinterpret_cast<S*>(maps + 3 * Cong::kMap);

  if (t == 0) ticket_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  // Position i is element n - 1 - p0 - i.
  const long long b = ticket_of_block, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);
  const Acc qb = Acc(*x.qbar), lb = Acc(*x.lbar);
  Cong cop;
  cop.m = m;
  cop.cols = 1;
  Aff aop;
  aop.m = m;
  aop.cols = 1;

  const auto src_of = [&](int c) {
    return c == 0    ? x.y
           : c == 1  ? x.ics
           : c < OQ  ? x.ps + (long long)(c - OP) * n
           : c < OE  ? x.qs + (long long)(c - OQ) * n
           : c < OA  ? x.es + (long long)(c - OE) * n
           : c < OF  ? x.as + (long long)(c - OA) * n
                     : x.Fs + (long long)(c - OF) * n;
  };
  const WideStream<S, L::kChunk, decltype(src_of)> io{
      raw, src_of, n, p0, cnt, IN, true,
      L::kChunk * sizeof(S) >= 16 && (n * (long long)sizeof(S)) % 16 == 0 && aligned16(x.y) &&
          aligned16(x.ics) && aligned16(x.ps) && aligned16(x.qs) && aligned16(x.es) &&
          aligned16(x.as) && aligned16(x.Fs)};
  const auto val = [&](int c, int jj) { return io.val(c, jj); };
  // The transition A^T (i, l) = a (l, i) - wd_l p_i of position jj into a
  // map of row stride ld.
  const auto transition = [&](Acc* el, int ld, int jj) {
    const Acc* dv = D + jj * DS;
    for (int idx = t; idx < mm; idx += kWideThreads) {
      const int i = idx / m, l = idx - i * m;
      el[i * ld + l] = val(OA + l * m + i, jj) - dv[DW + l] * val(OP + i, jj);
    }
  };

  // Phase A: the emissions, then the affine adjoint's fold (maps of Aff's
  // size: 0 and 1 the running map, 2 the element).
  int cur = 0, nxt = 1;
  Acc* el = maps + 2 * Aff::kMap;
  wide_zero(el, Aff::kMap);
  Aff::identity_map(maps);
  io.fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    io.arrive(jj);
    Acc* dv = D + jj * DS;
    for (int i = t; i < m; i += kWideThreads) {
      Acc acc = Acc(0);
      for (int j = 0; j < m; ++j) acc += val(OF + i * m + j, jj) * val(OP + j, jj);
      dv[DFP + i] = acc;
    }
    __syncthreads();
    const Acc ic = val(1, jj), ic2 = ic * ic;
    for (int i = t; i < m; i += kWideThreads) {
      Acc acc = val(OQ + i, jj);
      for (int j = 0; j < m; ++j) acc -= val(OA + i * m + j, jj) * dv[DFP + j];
      dv[DU + i] = acc;
      dv[DW + i] = acc * ic2;
    }
    if (t == kWideThreads - 1) {
      Acc pe = Acc(0);
      for (int i = 0; i < m; ++i) pe += val(OP + i, jj) * val(OE + i, jj);
      const Acc r = val(0, jj) - pe, alpha = r * ic, alphabar = Acc(2) * qb * alpha;
      dv[DSC] = ic;
      dv[DSC + 1] = ic2;
      dv[DSC + 2] = r;
      dv[DSC + 3] = alpha;
      dv[DSC + 4] = alphabar;
      dv[DSC + 5] = -lb / ic + alphabar * alpha / ic;
    }
    __syncthreads();
    transition(el, ALM, jj);
    for (int i = t; i < m; i += kWideThreads) el[i * ALM + P] = -(dv[DSC + 4] * ic) * val(OP + i, jj);
    __syncthreads();
    io.next(jj);
    w_fold(aop, maps + cur * Aff::kMap, el, maps + nxt * Aff::kMap, scr, vec);
    const int sw = cur;
    cur = nxt;
    nxt = sw;
  }
  wide_lookback(aop, b, lay.nt, lay.slots(work, 0, Aff::kMap), maps, cur, scr, st, s);

  // Phase B: the walk of mu and the glue, and the congruence adjoint's
  // fold (maps of Cong's size: 0 and 1 the running map, 2 the element).
  cur = 0;
  nxt = 1;
  el = maps + 2 * Cong::kMap;
  wide_zero(el, Cong::kMap);
  Cong::identity_map(maps);
  io.fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    io.arrive(jj);
    Acc* dv = D + jj * DS;
    transition(el, CLM, jj);
    for (int i = t; i < m; i += kWideThreads) dv[DMU + i] = st[i * ALS];
    __syncthreads();
    const Acc ic = dv[DSC], ic2 = dv[DSC + 1], r = dv[DSC + 2];
    // mu' = A^T mu + ebar, into vec; c2bar by one thread.
    for (int i = t; i < m; i += kWideThreads) {
      Acc acc = -(dv[DSC + 4] * ic) * val(OP + i, jj);
      for (int l = 0; l < m; ++l) acc += el[i * CLM + l] * dv[DMU + l];
      vec[i] = acc;
    }
    if (t == kWideThreads - 1) {
      Acc uw = Acc(0);
      for (int i = 0; i < m; ++i) uw += dv[DU + i] * (dv[DMU + i] * r);
      dv[DSC + 6] = Acc(-0.5) * (dv[DSC + 5] + Acc(2) * ic * uw) * ic * ic2;
    }
    __syncthreads();
    const Acc c2bar = dv[DSC + 6];
    for (int j = t; j < m; j += kWideThreads) {
      Acc acc = -c2bar * val(OP + j, jj);
      for (int i = 0; i < m; ++i) acc -= val(OA + i * m + j, jj) * (dv[DMU + i] * r * ic2);
      dv[DFB + j] = acc;
      st[j * ALS] = vec[j];
    }
    __syncthreads();
    for (int idx = t; idx < mm; idx += kWideThreads) {
      const int i = idx / m, j = idx - i * m;
      el[i * CLM + P + j] = dv[DFB + i] * val(OP + j, jj) + val(OP + i, jj) * dv[DFB + j];
    }
    __syncthreads();
    io.next(jj);
    w_fold(cop, maps + cur * Cong::kMap, el, maps + nxt * Cong::kMap, scr, vec);
    const int sw = cur;
    cur = nxt;
    nxt = sw;
  }
  wide_lookback(cop, b, lay.nt, lay.slots(work, 1, Cong::kMap), maps, cur, scr, st, s);

  // Phase C: the walk of S and the cotangents. Map 0 the element, 1 and 2
  // the padded a and F (row stride CLS); s is S a F; vec holds Su, a^T Su,
  // F^T Fpbar, F a^T Su at P apart.
  el = maps;
  Acc* am = maps + Cong::kMap;
  Acc* fm = maps + 2 * Cong::kMap;
  wide_zero(maps, 3 * Cong::kMap);
  io.fetch(0);
  Acc *Su = vec, *aTSu = vec + P, *FTfb = vec + 2 * P, *FaTSu = vec + 3 * P;
  for (int jj = 0; jj < cnt; ++jj) {
    io.arrive(jj);
    const Acc* dv = D + jj * DS;
    const long long k = n - 1 - p0 - jj;
    transition(el, CLM, jj);
    for (int idx = t; idx < mm; idx += kWideThreads) {
      const int i = idx / m, j = idx - i * m;
      el[i * CLM + P + j] = dv[DFB + i] * val(OP + j, jj) + val(OP + i, jj) * dv[DFB + j];
      am[i * CLS + j] = val(OA + idx, jj);
      fm[i * CLS + j] = val(OF + idx, jj);
    }
    for (int i = t; i < m; i += kWideThreads) {
      Acc acc = Acc(0);
      for (int l = 0; l < m; ++l) acc += st[i * CLS + l] * dv[DU + l];
      Su[i] = acc;
    }
    __syncthreads();
    for (int j = t; j < m; j += kWideThreads) {
      Acc a1 = Acc(0), a2 = Acc(0);
      for (int i = 0; i < m; ++i) {
        a1 += am[i * CLS + j] * Su[i];
        a2 += fm[i * CLS + j] * dv[DFB + i];
      }
      aTSu[j] = a1;
      FTfb[j] = a2;
    }
    __syncthreads();
    for (int j = t; j < m; j += kWideThreads) {
      Acc acc = Acc(0);
      for (int i = 0; i < m; ++i) acc += fm[j * CLS + i] * aTSu[i];
      FaTSu[j] = acc;
    }
    // S a, then (S a) F into s (each ends with the block's barrier).
    BlockMM::mm<P, P, P>(SmemRd{st}, CLS, 1, SmemRd{am}, CLS, 1, scr, CLS);
    BlockMM::mm<P, P, P>(SmemRd{scr}, CLS, 1, SmemRd{fm}, CLS, 1, s, CLS);
    const Acc ic = dv[DSC], ic2 = dv[DSC + 1], r = dv[DSC + 2], alphabar = dv[DSC + 4],
              c2bar = dv[DSC + 6], ic4 = ic2 * ic2;
    Acc uSu = Acc(0), wmu = Acc(0);
    for (int i = 0; i < m; ++i) {
      uSu += dv[DU + i] * Su[i];
      wmu += dv[DW + i] * dv[DMU + i];
    }
    for (int idx = t; idx < mm; idx += kWideThreads) {
      const int i = idx / m, j = idx - i * m;
      const Acc fpj = dv[DFP + j];
      x.asbar[(long long)idx * n + k] =
          S(s[i * CLS + j] + dv[DMU + i] * (val(OE + j, jj) - r * ic2 * fpj) - ic2 * Su[i] * fpj);
    }
    for (int j = t; j < m; j += kWideThreads) {
      const Acc fpj = dv[DFP + j];
      x.psbar[(long long)j * n + k] = S(-(alphabar * ic + wmu) * val(OE + j, jj) - c2bar * fpj +
                                        uSu * ic4 * fpj + FTfb[j] - ic2 * FaTSu[j]);
      x.qsbar[(long long)j * n + k] = S((dv[DMU + j] * r + Su[j]) * ic2);
    }
    if (t == 0) {
      x.dbar[k] = S(c2bar - Acc(0.5) * uSu * ic4);
      x.ybar[k] = S(alphabar * ic + wmu);
    }
    __syncthreads();
    io.next(jj);
    w_walk(cop, st, el, scr, vec);
  }
}

// ---------------------------------------------------------------- dispatch

bool order_ok(int m, long long n) {
  return m >= kLoglikWideMinM && m <= kLoglikWideMaxM && n >= 1;
}

// The workspaces (the same for either storage type: the tiles are).
FwdLayout b1w_layout(int m, long long n) {
  const long long nt = (n + kB1WideTile - 1) / kB1WideTile;
  return m <= 24 ? FwdLayout(nt, RicOp<24, BlockMM>::kMap, RicOp<24, BlockMM>::kState)
                 : FwdLayout(nt, RicOp<32, BlockMM>::kMap, RicOp<32, BlockMM>::kState);
}

ChainLayout b2w_layout(int m, long long n) {
  const long long nt = (n + kB2WideTile - 1) / kB2WideTile;
  return m <= 24
             ? ChainLayout(nt, 2, CongOp<24, false, BlockMM>::kMap,
                           CongOp<24, false, BlockMM>::kState, kMonoGroup)
             : ChainLayout(nt, 2, CongOp<32, false, BlockMM>::kMap,
                           CongOp<32, false, BlockMM>::kState, kMonoGroup);
}

template <int P, typename S>
cudaError_t run_b1(int m, long long n, const FwdArgs<S>& x, Acc* work, cudaStream_t st) {
  const FwdLayout L = b1w_layout(m, n);
  if (L.chain.nt > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(work + L.chain.flags, 0, L.zero_bytes(), st);
  if (e != cudaSuccess) return e;
  return g_launch(b1_wide_kernel<P, S>, dim3((unsigned)L.chain.nt), kWideThreads,
                  B1WideSmem<P, S>::kBytes, st, m, n, x, work, L);
}

template <int P, typename S>
cudaError_t run_b2(int m, long long n, const BwdArgs<S>& x, Acc* work, cudaStream_t st) {
  const ChainLayout L = b2w_layout(m, n);
  if (L.nt > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(work + L.flags, 0, L.flag_words * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  return g_launch(b2_wide_kernel<P, S>, dim3((unsigned)L.nt), kWideThreads,
                  B2WideSmem<P, S>::kBytes, st, m, n, x, work, L);
}

template <typename S>
int loglik(int m, long long n, const FwdArgs<S>& x, Acc* work, long long work_elems,
           void* stream) {
  if (!order_ok(m, n) || work_elems < b1w_layout(m, n).total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(m <= 24 ? run_b1<24, S>(m, n, x, work, st) : run_b1<32, S>(m, n, x, work, st));
}

template <typename S>
int loglik_bwd(int m, long long n, const BwdArgs<S>& x, Acc* work, long long work_elems,
               void* stream) {
  if (!order_ok(m, n) || work_elems < b2w_layout(m, n).total) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(m <= 24 ? run_b2<24, S>(m, n, x, work, st) : run_b2<32, S>(m, n, x, work, st));
}

}  // namespace

extern "C" {

// Workspaces, in float64 elements; -1 for an order this library does not
// take (it takes 16 < m <= 32).
long long qsl_workspace_elems(int m, int n) { return order_ok(m, n) ? b1w_layout(m, n).total : -1; }

long long qsl_bwd_workspace_elems(int m, int n) {
  return order_ok(m, n) ? b2w_layout(m, n).total : -1;
}

// B1 and B1r's association: elements per tile and per team (the tile)
// into tile[0], sub[0]; returns 0, or -1 for an order this library does
// not take.
int qsl_fwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (!order_ok(m, 1) || (bytes != 4 && bytes != 8)) return -1;
  *tile = *sub = kB1WideTile;
  return 0;
}

// B2's association, as qsl_fwd_schedule's.
int qsl_bwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (!order_ok(m, 1) || (bytes != 4 && bytes != 8)) return -1;
  *tile = *sub = kB2WideTile;
  return 0;
}

int qsl_loglik_f32(int m, int n, const float* d, const float* ps, const float* qs,
                   const float* as, const float* y, float* out, double* work,
                   long long work_elems, void* stream) {
  const FwdArgs<float> x{d, ps, qs, as, y, out, nullptr, nullptr, nullptr};
  return loglik<float>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_f64(int m, int n, const double* d, const double* ps, const double* qs,
                   const double* as, const double* y, double* out, double* work,
                   long long work_elems, void* stream) {
  const FwdArgs<double> x{d, ps, qs, as, y, out, nullptr, nullptr, nullptr};
  return loglik<double>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_res_f32(int m, int n, const float* d, const float* ps, const float* qs,
                       const float* as, const float* y, float* out, float* Fs, float* es,
                       float* ics, double* work, long long work_elems, void* stream) {
  const FwdArgs<float> x{d, ps, qs, as, y, out, Fs, es, ics};
  return loglik<float>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_res_f64(int m, int n, const double* d, const double* ps, const double* qs,
                       const double* as, const double* y, double* out, double* Fs, double* es,
                       double* ics, double* work, long long work_elems, void* stream) {
  const FwdArgs<double> x{d, ps, qs, as, y, out, Fs, es, ics};
  return loglik<double>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_bwd_f32(int m, int n, const float* ps, const float* qs, const float* as,
                       const float* y, const float* Fs, const float* es, const float* ics,
                       const float* qbar, const float* lbar, float* dbar, float* psbar,
                       float* qsbar, float* asbar, float* ybar, double* work,
                       long long work_elems, void* stream) {
  const BwdArgs<float> x{ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar, psbar, qsbar, asbar, ybar};
  return loglik_bwd<float>(m, n, x, work, work_elems, stream);
}

int qsl_loglik_bwd_f64(int m, int n, const double* ps, const double* qs, const double* as,
                       const double* y, const double* Fs, const double* es, const double* ics,
                       const double* qbar, const double* lbar, double* dbar, double* psbar,
                       double* qsbar, double* asbar, double* ybar, double* work,
                       long long work_elems, void* stream) {
  const BwdArgs<double> x{ps, qs, as, y, Fs, es, ics, qbar, lbar, dbar, psbar, qsbar, asbar, ybar};
  return loglik_bwd<double>(m, n, x, work, work_elems, stream);
}

const char* qsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
