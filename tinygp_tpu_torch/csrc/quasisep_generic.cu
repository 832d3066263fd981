// Kernel B3, the generic monoid scan, up to order 16 on Hopper (sm_90a).
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_scan.py:
// _scan_kernel (line 331), launched by pallas_monoid_scan (line 405), for
// the orders quasisep_scan.cu's templates do not take, up to 16: the
// affine, congruence and Riccati monoids with 4 < m <= 16 and the coupling
// of any pair of orders up to 16 other than two equal orders up to 4
// (above 16, quasisep_wide.cu). The TPU
// kernel takes any order (pallas_scan.py:82-124, supports); the JAX
// package sends every monoid with combine_lists to it (scan.py:195-201).
//
// The operands and the output are laid out as quasisep_scan.cu's: stacked,
// a (k, n) operand holding component c of element j at [c * n + j], in
// float32 or float64; the affine loads B and states (m * r, n) with row
// i * r + col; the Riccati flow reads (d, ps, qs, as) and forms its
// Moebius map in the kernel; the coupling reads A (m * m, n), B (m2 * m2, n)
// and C (m * m2, n) and writes C's leaf, (m * m2, n).
//
// One launch and one memset of its flags, tiles taken by a ticket and a
// deterministic grouped look-back (quasisep_common.cuh), for:
//   - the coupling g' = A g B^T + C with max(m, m2) <= kCplMaxM (Matern52's
//     (6, 6) and the 2-term celerite's (8, 8) on the conditioning path):
//     cpl_tile_kernel below, B2's warp design (quasisep_loglik_generic.cu:
//     b2_warp_kernel) run forwards;
//   - the Riccati flow, the affine scan (any columns) and the congruence
//     scan, either direction and output, at 5 <= m <= 16 (the posterior
//     processes of order 8, 12 and 16 and their gradients' reverse
//     congruence scans, the m = 5 sums), and the coupling whose larger
//     order is 9..16 (the order-5 and order-9 sums' conditioning):
//     ric_tile_kernel, aff_tile_kernel, cong_tile_kernel and
//     cpl_tc_tile_kernel, the same skeleton with every element's product
//     on the float64 tensor cores (their section below; the Ops, shared
//     with B2 above m = 8 and with quasisep_wide.cu, are in
//     quasisep_tc.cuh).
// cpl_tile_kernel. Each block takes a tile of kCplTeams * sub consecutive
// (for a reverse scan mirrored) positions by a ticket (quasisep_common.cuh:
// the one-launch look-back); each of its kCplTeams warps is a team that
// owns sub consecutive positions of it, with the orders read at run time.
//
//   staging: each component's run for the tile is contiguous, so the block
//            copies it once, coalesced, with cp.async into shared memory in
//            the operands' type, component c of position i at c * LD + i
//            (LD = tile + 1, odd, so that lanes reading different
//            components of one element hit different banks); nothing is
//            read from device memory again.
//   fold:    each team folds its elements into one full map
//            (Phi_A, Phi_B, C_span) = (A_k .. A_1, B_k .. B_1, the span's
//            C). Maps are padded to 8 x 8 (CplLane), so each lane owns two
//            entries of each product and reads its operands into registers
//            with no predicates; two warp barriers an element.
//   scan:    the teams' maps are scanned in the tile (Kogge-Stone, two
//            rounds of merges); the tile publishes its aggregate, and the
//            grouped look-back, its group fold split into runs of tiles
//            folded by the block's warps at once (cpl_lookback), gives the
//            state at the tile's start.
//   walk:    each team applies the prefix of the teams before it to the
//            tile's start and walks its elements with the sequential step
//            A g B^T + C, putting the state before (exclusive) or after
//            (inclusive) each element over the element's staged C; the
//            block then writes the states out coalesced.
//
// Every product runs in float64 (Acc) whatever the storage type, and the
// look-back composes in one fixed order, so two launches on the same
// inputs agree bit for bit; cuda_scan.plain_scan_tiled is this association
// in plain PyTorch. What bounds it: bytes, (m^2 + m2^2 + 2 m m2) values an
// element; the float64 fold (2 m^3 + 2 m m2 (m + m2) multiply-adds an
// element at m = m2, run at 8 x 8) fits under that bound at the FMA rate.
// The cost against the bound: latency, a tile's staging, its fold and walk
// through shared memory with a barrier per product, and its look-back's
// merges of full maps (about half of a tile, PERF.md).

#include "quasisep_tc.cuh"

namespace {

// ------------------------------------------------ the coupling, one launch

constexpr int kCplTeams = 4;      // warp teams a tile
constexpr int kCplMaxM = 8;       // largest order of the one-launch coupling
constexpr int kCplLd = kCplMaxM + 1;          // a padded block's row stride (odd: see CplLane)
constexpr int kCplPad = kCplMaxM * kCplLd;     // a padded block: 8 x 8
constexpr int kCplMap = 3 * kCplPad;           // a padded map [A | B | C]
constexpr int kCplQ = (kCplMap + 31) / 32;     // a lane's entries of a padded map
constexpr int kCplWindow = 4;     // aggregates a look-back stages at once
constexpr long long kCplStageBytes = 32 * 1024;  // most bytes of a staged tile

inline bool cpl_one_launch(const GSpec& s) {
  return s.kind == gCpl && s.m <= kCplMaxM && s.m2 <= kCplMaxM;
}

// Elements per team: the largest of 32, 16, 8 whose staged tile fits
// kCplStageBytes (8 at least). cuda_scan.b3_schedule repeats it.
__host__ __device__ inline int cpl_sub(int m1, int m2, int bytes) {
  const long long comps = (long long)m1 * m1 + m2 * m2 + m1 * m2;
  int sub = 32;
  while (sub > 8 && comps * (kCplTeams * sub + 1) * bytes > kCplStageBytes) sub /= 2;
  return sub;
}

// The look-back publishes padded maps and states.
inline ChainLayout cpl_layout(const GSpec& s, long long n, int bytes) {
  const long long tile = kCplTeams * cpl_sub(s.m, s.m2, bytes);
  return ChainLayout((n + tile - 1) / tile, 1, kCplMap, kCplPad);
}

// A team's shared values, in Acc: two running maps, an element, the
// state, its next value and a product's scratch, all padded.
constexpr int kCplTeamElems = 3 * kCplMap + 3 * kCplPad;

// Shared memory of a block, in bytes: the look-back's window, its three
// maps (Q, its next value, the group's aggregate), the tile's start, a
// state and a scratch, the teams' values (all Acc), then the staged tile.
inline long long cpl_smem(const GSpec& s, int bytes) {
  const int comps = g_size(s, 1), tile = kCplTeams * cpl_sub(s.m, s.m2, bytes);
  return (long long)((kCplWindow + 3) * kCplMap + 3 * kCplPad + kCplTeams * kCplTeamElems) *
             sizeof(Acc) +
         (long long)comps * (tile + 1) * bytes;
}

// A lane's share of a warp's coupling products. Every map is kept padded
// to kCplMaxM: [A | B | C], each an 8 x 8 block of row stride kCplLd that
// is 0 outside the orders (m1 x m1, m2 x m2, m1 x m2); every product keeps
// the padding 0, so the products run at 8 x 8 whatever the orders,
// unrolled and without predicates. Lane (r, j) = (lane / 8, lane % 8) owns
// entries (r, j) and (r + 4, j) of each 8 x 8 output; its operands are
// loaded into registers before the sums. The odd row stride puts a warp's
// reads of different rows in different banks. src[q] is the staged
// component of padded entry lane + 32 q (-1 in the padding).
struct CplLane {
  int i0, i1, j;
  int src[kCplQ];
  bool out0, out1;  // (i0, j), (i1, j) inside the m1 x m2 state

  __device__ CplLane(int lane, int m1, int m2) : i0(lane >> 3), i1((lane >> 3) + 4), j(lane & 7) {
    const int ob = m1 * m1, oc = ob + m2 * m2;
#pragma unroll
    for (int q = 0; q < kCplQ; ++q) {
      const int p = lane + 32 * q, part = p / kCplPad, i = p % kCplPad / kCplLd,
                k = p % kCplPad % kCplLd;
      const int rows = part == 1 ? m2 : m1, cols = part == 0 ? m1 : m2;
      src[q] = p >= kCplMap || i >= rows || k >= cols ? -1
               : part == 0                           ? i * m1 + k
               : part == 1                           ? ob + i * m2 + k
                                                     : oc + i * m2 + k;
    }
    out0 = i0 < m1 && j < m2;
    out1 = i1 < m1 && j < m2;
  }

  // out = (A_l A_e, B_l B_e, A_l C_e B_l^T + C_l) of the earlier map e and
  // the later l; T: kCplPad values. out aliases neither.
  __device__ __forceinline__ void merge(const Acc* __restrict__ e, const Acc* __restrict__ l,
                                        Acc* __restrict__ out, Acc* __restrict__ T) const {
    Acc la0[8], la1[8], ea[8], ec[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      la0[t] = l[i0 * kCplLd + t];
      la1[t] = l[i1 * kCplLd + t];
      ea[t] = e[t * kCplLd + j];
      ec[t] = e[2 * kCplPad + t * kCplLd + j];
    }
    Acc a0 = 0, a1 = 0, t0 = 0, t1 = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      a0 += la0[t] * ea[t];
      a1 += la1[t] * ea[t];
      t0 += la0[t] * ec[t];
      t1 += la1[t] * ec[t];
    }
    Acc lb0[8], lb1[8], eb[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      lb0[t] = l[kCplPad + i0 * kCplLd + t];
      lb1[t] = l[kCplPad + i1 * kCplLd + t];
      eb[t] = e[kCplPad + t * kCplLd + j];
    }
    Acc b0 = 0, b1 = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      b0 += lb0[t] * eb[t];
      b1 += lb1[t] * eb[t];
    }
    out[i0 * kCplLd + j] = a0;
    out[i1 * kCplLd + j] = a1;
    out[kCplPad + i0 * kCplLd + j] = b0;
    out[kCplPad + i1 * kCplLd + j] = b1;
    T[i0 * kCplLd + j] = t0;
    T[i1 * kCplLd + j] = t1;
    __syncwarp();
    out_c(l, T, out + 2 * kCplPad);
  }

  // gout = A g B^T + C for the map [A | B | C]; gout may alias g; T:
  // kCplPad values.
  __device__ __forceinline__ void apply(const Acc* map, const Acc* g, Acc* T, Acc* gout) const {
    Acc a0[8], a1[8], gc[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      a0[t] = map[i0 * kCplLd + t];
      a1[t] = map[i1 * kCplLd + t];
      gc[t] = g[t * kCplLd + j];
    }
    Acc t0 = 0, t1 = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      t0 += a0[t] * gc[t];
      t1 += a1[t] * gc[t];
    }
    T[i0 * kCplLd + j] = t0;
    T[i1 * kCplLd + j] = t1;
    __syncwarp();
    out_c(map, T, gout);
  }

  // c = map's C + T B^T, B being map's (the lane's two entries), then the
  // warp's barrier; c aliases neither map nor T.
  __device__ __forceinline__ void out_c(const Acc* map, const Acc* T, Acc* c) const {
    Acc b[8], t0[8], t1[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      b[t] = map[kCplPad + j * kCplLd + t];
      t0[t] = T[i0 * kCplLd + t];
      t1[t] = T[i1 * kCplLd + t];
    }
    Acc c0 = map[2 * kCplPad + i0 * kCplLd + j], c1 = map[2 * kCplPad + i1 * kCplLd + j];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      c0 += t0[t] * b[t];
      c1 += t1[t] * b[t];
    }
    c[i0 * kCplLd + j] = c0;
    c[i1 * kCplLd + j] = c1;
    __syncwarp();
  }
};

// The coupling's padded identity [I | I | 0] into v, by one warp.
__device__ __forceinline__ void cpl_identity(int m1, int m2, Acc* v) {
  for (int p = threadIdx.x & 31; p < kCplMap; p += 32) {
    const int part = p / kCplPad, i = p % kCplPad / kCplLd, k = p % kCplPad % kCplLd;
    v[p] = part < 2 && i == k && i < (part == 0 ? m1 : m2) ? Acc(1) : Acc(0);
  }
  __syncwarp();
}

// By the block, once the tile's aggregate agg (shared memory) is final:
// the state before tile b into st, publishing what later tiles need
// (quasisep_common.cuh: the one-launch look-back). Q, the composition of
// the aggregates of the group's tiles before b, is folded in runs of
// kCplRun tiles, warp r folding run r in order (into buf(r, 1) or
// buf(r, 2), one aggregate at a time through its window slot), and the
// runs composed as (run 0 . run 1) . (run 2 . run 3): one fixed
// association, whose depth is a run and two merges where B2's fold is up
// to 31 merges. Warp 0 then finds the state after the group before and
// publishes. lk holds three maps; s, tmp and T a state each.
constexpr int kCplRun = kLookGroup / kCplTeams;

template <class Buf>
__device__ void cpl_lookback(const CplLane& ln, int m1, int m2, long long b, long long nt,
                             const LookSlots& sl, const Acc* agg, Acc* win, Acc* lk, Acc* st,
                             Acc* s, Acc* tmp, Acc* T, Buf buf) {
  static_assert(kCplRun * kCplTeams == kLookGroup && kCplWindow >= kCplTeams, "a run a warp");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long g = b / kLookGroup, base = g * kLookGroup;
  const bool end = b % kLookGroup == kLookGroup - 1, more = b + 1 < nt;
  const int cnt = (int)(b - base);
  if (w == 0) {
    if (!end && more) publish_values(agg, sl.tile_agg + b * kCplMap, kCplMap, sl.tile_flag + b, 1u);
    if (lane < cnt) wait_nonzero(sl.tile_flag + base + lane);
  }
  __syncthreads();
  __threadfence();
  // Run r covers the group's tiles [kCplRun r, kCplRun r + len(r)); its
  // fold ends in run_map(r).
  const auto len = [&](int r) { return max(0, min(kCplRun, cnt - kCplRun * r)); };
  const auto run_map = [&](int r) { return buf(r, 1 + ((len(r) - 1) & 1)); };
  if (len(w) > 0) {
    const Acc* src = sl.tile_agg + (base + kCplRun * w) * kCplMap;
    Acc* P = buf(w, 1);
    Acc* Pn = buf(w, 2);
    Acc* slot = win + w * kCplMap;
    for (int c = lane; c < kCplMap; c += 32) P[c] = __ldcg(src + c);
    __syncwarp();
    for (int i = 1; i < len(w); ++i) {
      for (int c = lane; c < kCplMap; c += 32) slot[c] = __ldcg(src + i * kCplMap + c);
      __syncwarp();
      ln.merge(P, slot, Pn, T);
      Acc* swap = P;
      P = Pn;
      Pn = swap;
    }
  }
  __syncthreads();
  Acc *Q = lk, *GA = lk + kCplMap;
  const Acc* R0 = run_map(0);
  const Acc* R2 = run_map(2);
  if (len(1) > 0) {
    if (w == 0) ln.merge(R0, run_map(1), lk + 2 * kCplMap, T);
    R0 = lk + 2 * kCplMap;
  }
  if (len(3) > 0) {  // into team 2's other map buffer
    Acc* out = buf(2, 2 - ((len(2) - 1) & 1));
    if (w == 2) ln.merge(R2, run_map(3), out, T);
    R2 = out;
  }
  __syncthreads();
  if (w != 0) return;
  if (cnt == 0)
    cpl_identity(m1, m2, Q);
  else if (len(2) > 0)
    ln.merge(R0, R2, Q, T);
  else
    Q = const_cast<Acc*>(R0);
  if (end && more) {
    ln.merge(Q, agg, GA, tmp);
    publish_values(GA, sl.group_agg + g * kCplMap, kCplMap, sl.group_flag + g, 1u);
  }
  // S(g - 1): from the nearest group whose end state is published.
  const long long j = lookback_find(g, sl.group_flag);
  for (int c = lane; c < kCplPad; c += 32)
    s[c] = j >= 0 ? __ldcg(sl.group_state + j * kCplPad + c) : Acc(0);
  __syncwarp();
  for (long long i0 = j + 1; i0 < g; i0 += kCplWindow) {
    const int n_win = (int)(g - i0 < kCplWindow ? g - i0 : kCplWindow);
    lookback_window(sl.group_agg, i0, n_win, kCplMap, win);
    for (int l = 0; l < n_win; ++l) ln.apply(win + l * kCplMap, s, tmp, s);
  }
  ln.apply(Q, s, tmp, st);
  if (end && more) {
    ln.apply(GA, s, tmp, s);
    publish_values(s, sl.group_state + g * kCplPad, kCplPad, sl.group_flag + g, 2u);
  }
}

template <typename S>
__global__ void __launch_bounds__(32 * kCplTeams)
cpl_tile_kernel(GSpec spec, long long n, int reverse, int inclusive, GIn<S> in, S* out,
                Acc* work, ChainLayout lay, int sub) {
  const int m = spec.m, m2 = spec.m2, ob = m * m, oc = ob + m2 * m2;
  const int comps = g_size(spec, 1), T = kCplTeams * sub, LD = T + 1;
  __shared__ long long tile_of_block;
  Acc* win = reinterpret_cast<Acc*>(qsl_smem);
  Acc* lk = win + kCplWindow * kCplMap;
  Acc* start = lk + 3 * kCplMap;
  Acc* ls = start + kCplPad;
  Acc* ltmp = ls + kCplPad;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // Team v's map buffer k (0 or 1); team w's element, state, next state
  // and scratch.
  const auto buf = [&](int v, int k) { return ltmp + kCplPad + v * kCplTeamElems + k * kCplMap; };
  Acc* const el = buf(w, 2);
  Acc* g = buf(w, 3);
  Acc* nw = g + kCplPad;
  Acc* tm_ = nw + kCplPad;
  S* st = reinterpret_cast<S*>(ltmp + kCplPad + kCplTeams * kCplTeamElems);
  const CplLane ln(lane, m, m2);

  if (t == 0) tile_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  const long long b = tile_of_block, p0 = b * T;
  const int cnt = (int)(n - p0 < T ? n - p0 : T);

  // Stage the tile: position i (element p0 + i, or n - 1 - p0 - i) of
  // component c of [A | B | C] at st[c * LD + i].
  for (int idx = t; idx < comps * cnt; idx += 32 * kCplTeams) {
    const int c = idx / cnt, i = idx - c * cnt;
    const S* src = c < ob ? in.x0 + (long long)c * n
                   : c < oc ? in.x1 + (long long)(c - ob) * n
                            : in.x2 + (long long)(c - oc) * n;
    src += reverse ? n - 1 - p0 - i : p0 + i;
    cp_async_elem(st + c * LD + i, src);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int lo = w * sub, mine = max(0, min(sub, cnt - lo));
  // The team's element jj, padded, in Acc into el (after the products
  // that read the one before; a barrier follows).
  const auto convert = [&](int jj) {
#pragma unroll
    for (int q = 0; q < kCplQ; ++q)
      if (lane + 32 * q < kCplMap)
        el[lane + 32 * q] = ln.src[q] < 0 ? Acc(0) : Acc(st[ln.src[q] * LD + lo + jj]);
    __syncwarp();
  };

  // The fold: the team's map after each of its elements.
  {
    Acc *cur = buf(w, 0), *nxt = buf(w, 1);
    cpl_identity(m, m2, cur);
    for (int jj = 0; jj < mine; ++jj) {
      convert(jj);
      ln.merge(cur, el, nxt, tm_);
      Acc* swap = cur;
      cur = nxt;
      nxt = swap;
    }
    if (mine & 1) {
      for (int e = lane; e < kCplMap; e += 32) buf(w, 0)[e] = cur[e];
      __syncwarp();
    }
  }

  // The in-tile scan of the teams' maps (Kogge-Stone): team w's inclusive
  // value ends in buffer 0.
  static_assert(kCplTeams == 4, "two rounds of merges");
  __syncthreads();
  for (int off = 1, k = 0; off < kCplTeams; off <<= 1, k ^= 1) {
    if (w >= off)
      ln.merge(buf(w - off, k), buf(w, k), buf(w, k ^ 1), tm_);
    else
      for (int e = lane; e < kCplMap; e += 32) buf(w, k ^ 1)[e] = buf(w, k)[e];
    __syncthreads();
  }
  cpl_lookback(ln, m, m2, b, lay.nt, lay.slots(work, 0, kCplMap), buf(kCplTeams - 1, 0), win, lk,
               start, ls, ltmp, tm_, buf);
  __syncthreads();

  // The walk from the team's start, the state after the teams before it:
  // each element's state over its staged C.
  for (int c = lane; c < kCplPad; c += 32) g[c] = start[c];
  __syncwarp();
  if (w > 0) ln.apply(buf(w - 1, 0), g, tm_, g);
  for (int jj = 0; jj < mine; ++jj) {
    convert(jj);
    ln.apply(el, g, tm_, nw);
    const Acc* s = inclusive ? nw : g;
    if (ln.out0) st[(oc + ln.i0 * m2 + ln.j) * LD + lo + jj] = S(s[ln.i0 * kCplLd + ln.j]);
    if (ln.out1) st[(oc + ln.i1 * m2 + ln.j) * LD + lo + jj] = S(s[ln.i1 * kCplLd + ln.j]);
    Acc* swap = g;
    g = nw;
    nw = swap;
  }
  __syncthreads();
  for (int idx = t; idx < m * m2 * cnt; idx += 32 * kCplTeams) {
    const int c = idx / cnt, i = idx - c * cnt;
    out[(long long)c * n + (reverse ? n - 1 - p0 - i : p0 + i)] = st[(oc + c) * LD + i];
  }
}

// One memset (the ticket and the flags) and one launch, on stream st.
template <typename S>
cudaError_t cpl_run(const GSpec& s, long long n, int reverse, int inclusive, const GIn<S>& in,
                    S* out, Acc* work, const ChainLayout& lay, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(work + lay.flags, 0, lay.flag_words * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  return g_launch(cpl_tile_kernel<S>, dim3((unsigned)lay.nt), 32 * kCplTeams,
                  cpl_smem(s, (int)sizeof(S)), st, s, n, reverse, inclusive, in, out, work, lay,
                  cpl_sub(s.m, s.m2, (int)sizeof(S)));
}

// ---------- the Riccati flow, the affine and the congruence scan, one launch
//
// ric_tile_kernel, aff_tile_kernel, cong_tile_kernel and cpl_tc_tile_kernel
// replace the TPU kernel B3 (pallas_scan.py: _scan_kernel) for the Riccati
// flow, the affine scan and the congruence scan at m = 5..16 and the
// coupling whose larger order is 9..16: the skeleton of cpl_tile_kernel (tiles of kMonoTeams warp
// teams by a ticket, staged once, an in-tile Kogge-Stone scan of the teams'
// maps, the grouped look-back, in groups of kMonoGroup tiles folded in
// runs of kMonoRun, the walk, the states written out from shared memory),
// with every element's product on the float64 tensor cores (mma.sync
// m16n8k8). The order m = 5..16 is padded to P = 8 or 16 with zeros, which
// every product keeps. Staging and write-out copy each component's run of
// the tile with the fewest requests the alignment allows (mono_tile).
//
// Their Ops, Frag and the products are in quasisep_tc.cuh. Per element a
// warp's running value stays in registers, in the layout of the mma's
// accumulator (Frag): lane (g, t) holds entries (8 h + g,
// 8 k + 2 t + j). The contraction of every product runs through each
// k-tile in the order (0, 2, 4, 6, 1, 3, 5, 7) for both operands, so an
// accumulator feeds the next product as its A operand as it is, and a Frag
// of Z feeds it as the B operand of X Z^T (xzt). The element's a, read
// once from the staged tile into the same layout, is the A operand of
// a F^T and the B operand of every (.) a^T. So the maps are kept
// transposed where that makes each update an X a^T:
//
//   Riccati (the rank-one fold, scan.py:riccati_fold_rank_one): with
//     f = F p, c = d - p^T f, u = q - a f and w = A^T p,
//     A^T' = A^T a^T - w u^T / c,  F' = (a F^T) a^T + u u^T / c,
//     G' = G - w w^T / c;
//   the walk F' = (a F^T) a^T + u u^T / c2 (F is symmetric: F^T for F);
//   affine, with rc columns of B: [A^T; B^T]' = [A^T; B^T] a^T + [0; b^T],
//   the walk s^T' = s^T a^T + b^T;
//   congruence: A^T' = A^T a^T, B' = a (a B^T)^T + b, three products an
//   element, and the walk g' = a (a g^T)^T + b; B and g are not taken to
//   be symmetric (the Riccati adjoint's loads are not);
//   coupling (CplOp, both orders padded to 16): A^T' = A^T a^T,
//   B^T' = B^T b^T, C' = a (b C^T)^T + c, four products an element, and the
//   walk g' = a (b g^T)^T + c; its look-back's merges of runs compensated
//   as the congruence's.
//
// The matrix-vector products are dot products over a lane's entries and
// two shuffles within its quad. The merges of whole maps (the in-tile
// scan and the look-back) work on padded maps in shared memory, one warp
// each, with the products on the tensor cores too (smm) and, for the
// Riccati flow's Moebius merge and its application to a state, a
// Gauss-Jordan elimination with partial pivoting in registers (warp_gj: a
// lane a column of [M | R]). No inverse is taken per element; the
// congruence's merge (A_l A_e, (A_l B_e) A_l^T + B_l) and application
// (A g) A^T + B take none at all, three and two products; its look-back's
// merges of runs of tiles are compensated dot products on the CUDA cores
// (CongOp: composed over long spans, its maps' terms cancel by orders of
// magnitude on the posterior processes' Riccati adjoint). The affine
// columns go in groups of kAffCols8 (r <= 8) or kAffCols16 on the ticket
// (ticket = tile * groups + group), each group a chain of its own.
//
// Every product runs in float64 whatever the storage type, and the
// look-back composes in one fixed order, so two launches on the same
// inputs agree bit for bit; cuda_scan.plain_scan_tiled is this association
// in plain PyTorch. What bounds them: bytes (the Riccati flow reads
// 1 + 2m + m^2 values an element and writes m^2; the affine scan m^2 + m r
// and m r; the congruence 2 m^2 and m^2); the float64 tensor cores' 67 TFLOP/s are far from binding.
// The cost against the bound is latency, with one block a multiprocessor
// at P = 16: the look-back's merges and applications on one warp (a
// 16 x 16 pivoted inverse and six products, about 5 us each for the
// Riccati flow), the copy requests of staging and write-out, and a warp's
// chain of dependent products and shuffles per element (PERF.md).

constexpr int kMonoMinM = 5, kMonoMaxM = 16;        // orders of the one-launch scans
constexpr int kAffCols8 = 8, kAffCols16 = 16;       // affine columns a group
constexpr long long kMonoStageCap = 104 * 1024;     // most bytes of a staged tile

// The Riccati flow, the affine and the congruence scan at m = 5..16, and
// the couplings whose larger order is 9..16 (both padded to 16).
inline bool mono_one_launch(const GSpec& s) {
  if (s.kind == gCpl) {
    const int big = s.m > s.m2 ? s.m : s.m2;
    return big > kCplMaxM && big <= kMonoMaxM;
  }
  return s.m >= kMonoMinM && s.m <= kMonoMaxM;
}

// Shared memory of a one-launch Riccati, affine, congruence or coupling block, in bytes: per
// team three maps, the merge's scratch and a state; the look-back's Q, GA
// and a window map; the tile's start and two states; then the staged tile
// of `comps` components.
template <class Op>
__host__ __device__ inline long long mono_fixed_bytes() {
  return (long long)(kMonoTeams * (3 * Op::kMap + Op::kScratch + Op::kState) + 3 * Op::kMap +
                     3 * Op::kState) *
         (long long)sizeof(Acc);
}

// Elements per team: the largest of 32, 16, 8, 4, 2, 1 whose staged tile
// fits min(kMonoStageCap, what the block's shared memory leaves).
// cuda_scan.b3_schedule repeats it.
template <class Op>
inline int mono_sub(int comps, int bytes) {
  long long room = kGenSharedBlock - mono_fixed_bytes<Op>() - 1024;
  if (room > kMonoStageCap) room = kMonoStageCap;
  int sub = 32;
  while (sub > 1 && (long long)comps * (kMonoTeams * sub * bytes + 16) > room) sub /= 2;
  return sub;
}

// Bulk copies between global and shared memory (the Tensor Memory
// Accelerator's non-tensor form), for the one-launch scans' staging and
// write-out (16-byte cp.async is in quasisep_tc.cuh).
constexpr int kBulkRowBytes = 512;  // the shortest staged row copied in bulk

__device__ __forceinline__ void bulk_bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The barrier's one arrival, expecting `bytes` from the copies.
__device__ __forceinline__ void bulk_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the barrier's first phase; traps after kWatchdogNs.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  const unsigned long long start = global_ns();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
    if (done) return;
    if (global_ns() - start > kWatchdogNs) __trap();
  }
}

// Order this thread's stores to shared memory before the bulk copies that
// read it.
__device__ __forceinline__ void bulk_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// Commit this thread's bulk stores and wait until they have read shared
// memory.
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// One tile of a one-launch Riccati, affine, congruence or coupling scan (the block's part of
// cpl_tile_kernel's design, over Op): the ticket, staging, the teams'
// folds in registers, the in-tile scan, the look-back, the walk from each
// team's start, and the coalesced write-out of the states.
template <class Op, typename S>
__device__ __forceinline__ void mono_tile(Op op, long long n, int r, int reverse, int inclusive,
                                          int groups, int cols, GIn<S> in, S* out, Acc* work,
                                          const ChainLayout& lay, int sub) {
  constexpr int MAP = Op::kMap, ST = Op::kState, SCR = Op::kScratch;
  constexpr int TEAM = 3 * MAP + SCR + ST;
  // A staged row: T values and 16 bytes, so that every row starts 16-byte
  // aligned for the bulk copies.
  const int m = op.m, T = kMonoTeams * sub, LD = T + 16 / (int)sizeof(S);
  __shared__ long long ticket_of_block;
  Acc* lk = reinterpret_cast<Acc*>(qsl_smem);
  Acc* start = lk + 3 * MAP;
  Acc* ls = start + ST;
  Acc* teams = ls + 2 * ST;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const auto buf = [&](int v, int k) { return teams + v * TEAM + k * MAP; };
  const auto scr = [&](int v) { return teams + v * TEAM + 3 * MAP; };
  Acc* const mine_state = teams + w * TEAM + 3 * MAP + SCR;
  __shared__ unsigned long long staged_bar;
  S* st = reinterpret_cast<S*>(
      (reinterpret_cast<size_t>(teams + kMonoTeams * TEAM) + 15) & ~size_t(15));

  if (t == 0) ticket_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  const long long b = ticket_of_block / groups, p0 = b * T;
  const int grp = (int)(ticket_of_block % groups), col0 = grp * cols;
  if constexpr (Op::kKind == gAff) op.cols = min(cols, r - col0);
  const int comps = Op::comps(m, op.cols);
  const int cnt = (int)(n - p0 < T ? n - p0 : T);

  // Stage the tile: position i (element p0 + i, or n - 1 - p0 - i) of
  // staged component c at st[c * LD + i]. A copy request costs about the
  // same whatever its size (some 30 ns of a block's staging each, measured
  // on the card), so the requests are made as large as the layout allows.
  // Forward, with every operand 16-byte aligned: each component's run is
  // one bulk copy (the Tensor Memory Accelerator, completing on an
  // mbarrier) where it is at least kBulkRowBytes, else 16 bytes a lane by
  // cp.async; otherwise every value by cp.async. Any values past a
  // multiple of 16 bytes go by cp.async. A warp takes 32 / lpc components
  // at once, lpc lanes each (T is a power of two), so that no division
  // runs per element.
  const int lpc = T < 32 ? T : 32, lsh = __ffs(lpc) - 1;
  const auto pos = [&](int i) { return reverse ? n - 1 - p0 - i : p0 + i; };
  const auto comp_src = [&](int c) {
    if constexpr (Op::kKind == gAff) {
      const int mm = m * m, q = c - mm;
      return c < mm ? in.x0 + (long long)c * n
                    : in.x1 + ((long long)(q / op.cols) * r + col0 + q % op.cols) * n;
    } else if constexpr (Op::kKind == gCong) {
      return c < m * m ? in.x0 + (long long)c * n : in.x1 + (long long)(c - m * m) * n;
    } else if constexpr (Op::kKind == gCpl) {
      const int ob = m * m, oc = ob + op.cols * op.cols;
      return c < ob   ? in.x0 + (long long)c * n
             : c < oc ? in.x1 + (long long)(c - ob) * n
                      : in.x2 + (long long)(c - oc) * n;
    } else {
      return c == 0       ? in.x0
             : c <= m     ? in.x1 + (long long)(c - 1) * n
             : c <= 2 * m ? in.x2 + (long long)(c - 1 - m) * n
                          : in.x3 + (long long)(c - 1 - 2 * m) * n;
    }
  };
  const bool bulk = !reverse && (n * (long long)sizeof(S)) % 16 == 0 &&
                    aligned16(in.x0) && aligned16(in.x1) && aligned16(in.x2) &&
                    aligned16(in.x3) && aligned16(out);
  const int whole = (int)(cnt * sizeof(S) / 16 * 16 / sizeof(S));  // values in 16-byte units
  const int chunk = 16 / (int)sizeof(S);  // values a 16-byte copy moves
  if (bulk && T * (int)sizeof(S) >= kBulkRowBytes) {
    if (t == 0) bulk_bar_init(&staged_bar);
    __syncthreads();  // (the one barrier the bulk path adds)
    if (w == 0) {
      if (lane == 0) bulk_expect(&staged_bar, (unsigned)(comps * whole * sizeof(S)));
      __syncwarp();
      if (whole > 0)
        for (int c = lane; c < comps; c += 32)
          bulk_load(st + c * LD, comp_src(c) + p0, (unsigned)(whole * sizeof(S)), &staged_bar);
    }
    for (int c = w; c < comps && whole < cnt; c += kMonoTeams)
      for (int i = whole + lane; i < cnt; i += 32) cp_async_elem(st + c * LD + i, comp_src(c) + pos(i));
  } else if (bulk) {
    const int cpr = T / chunk, lpr = cpr < 32 ? cpr : 32, sh = __ffs(lpr) - 1;
    for (int c = w * (32 >> sh) + (lane >> sh); c < comps; c += kMonoTeams * (32 >> sh)) {
      const S* src = comp_src(c) + p0;
      for (int k = (lane & (lpr - 1)) * chunk; k < whole; k += lpr * chunk)
        cp_async16(st + c * LD + k, src + k);
      for (int i = whole + (lane & (lpr - 1)); i < cnt; i += lpr) cp_async_elem(st + c * LD + i, src + i);
    }
  } else {
    for (int c = w * (32 >> lsh) + (lane >> lsh); c < comps; c += kMonoTeams * (32 >> lsh)) {
      const S* src = comp_src(c);
      for (int i = lane & (lpc - 1); i < cnt; i += lpc) cp_async_elem(st + c * LD + i, src + pos(i));
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  if (bulk && T * (int)sizeof(S) >= kBulkRowBytes) bulk_wait(&staged_bar);
  __syncthreads();
  const int lo = w * sub, mine = max(0, min(sub, cnt - lo));

  // The fold: the team's map, in registers, then into buffer 0.
  {
    typename Op::Run x;
    Op::identity(x);
    typename Op::El e, next;
    if (mine > 0) op.load(st, LD, lo, next);
    for (int jj = 0; jj < mine; ++jj) {
      e = next;
      if (jj + 1 < mine) op.load(st, LD, lo + jj + 1, next);
      Op::fold(x, e);
    }
    Op::store(x, buf(w, 0));
  }

  mono_team_scan(op, buf, scr);
  mono_lookback(op, b, lay.nt, lay.slots(work, grp, MAP), buf(kMonoTeams - 1, 0), lk, start, ls,
                buf, scr);
  __syncthreads();

  // The walk from the team's start, the state after the teams before it,
  // each element's state over its staged components.
  if (mine > 0) {
    mono_team_start(op, buf, scr, start, mine_state);
    typename Op::State x;
    Op::load_state(mine_state, x);
    typename Op::El e, next;
    op.load(st, LD, lo, next);
    for (int jj = 0; jj < mine; ++jj) {
      e = next;
      if (jj + 1 < mine) op.load(st, LD, lo + jj + 1, next);
      if (!inclusive) op.put(x, st, LD, lo + jj);
      Op::walk(x, e);
      if (inclusive) op.put(x, st, LD, lo + jj);
    }
  }
  if (bulk) bulk_fence();
  __syncthreads();
  const int rows = op.out_rows();
  const auto out_row = [&](int q) {
    return Op::kKind == gAff ? (long long)(q / op.cols) * r + col0 + q % op.cols : (long long)q;
  };
  if (bulk) {
    // Each row's run from shared memory by one bulk copy, its last values
    // past a multiple of 16 bytes by plain stores; the block waits until
    // the copies have read shared memory.
    if (whole > 0)
      for (int q = t; q < rows; q += 32 * kMonoTeams)
        bulk_store(out + out_row(q) * n + p0, st + op.out_comp(q) * LD,
                   (unsigned)(whole * sizeof(S)));
    for (int q = w; q < rows && whole < cnt; q += kMonoTeams)
      for (int i = whole + lane; i < cnt; i += 32)
        out[out_row(q) * n + p0 + i] = st[op.out_comp(q) * LD + i];
    bulk_store_wait();
  } else {
    for (int q = w * (32 >> lsh) + (lane >> lsh); q < rows; q += kMonoTeams * (32 >> lsh)) {
      const S* src = st + op.out_comp(q) * LD;
      for (int i = lane & (lpc - 1); i < cnt; i += lpc) out[out_row(q) * n + pos(i)] = src[i];
    }
  }
}

// B3's Riccati flow at 5 <= m <= 16 (padded to P), exclusive: (d, ps, qs,
// as_) in, F (m^2, n) out.
template <int P, typename S>
__global__ void __launch_bounds__(32 * kMonoTeams)
ric_tile_kernel(int m, long long n, GIn<S> in, S* out, Acc* work, ChainLayout lay, int sub) {
  RicOp<P> op;
  op.m = m;
  mono_tile(op, n, 1, 0, 0, 1, 1, in, out, work, lay, sub);
}

// B3's affine scan at 5 <= m <= 16 (padded to P), r columns in groups of
// RC, forward or reverse, exclusive or inclusive: (A, B) in, (m r, n) out.
template <int P, int RC, typename S>
__global__ void __launch_bounds__(32 * kMonoTeams)
aff_tile_kernel(int m, long long n, int r, int reverse, int inclusive, int groups, GIn<S> in,
                S* out, Acc* work, ChainLayout lay, int sub) {
  AffOp<P, RC> op;
  op.m = m;
  op.cols = RC;
  mono_tile(op, n, r, reverse, inclusive, groups, RC, in, out, work, lay, sub);
}

// B3's congruence scan at 5 <= m <= 16 (padded to P), forward or reverse,
// exclusive or inclusive: (A, B) in, (m^2, n) out.
template <int P, typename S>
__global__ void __launch_bounds__(32 * kMonoTeams)
cong_tile_kernel(int m, long long n, int reverse, int inclusive, GIn<S> in, S* out, Acc* work,
                 ChainLayout lay, int sub) {
  CongOp<P, true> op;
  op.m = m;
  mono_tile(op, n, 1, reverse, inclusive, 1, 1, in, out, work, lay, sub);
}

// B3's coupling whose larger order is 9..16 (both padded to 16), forward or
// reverse, exclusive or inclusive: (A, B, C) in, (m m2, n) out.
template <typename S>
__global__ void __launch_bounds__(32 * kMonoTeams)
cpl_tc_tile_kernel(int m, int m2, long long n, int reverse, int inclusive, GIn<S> in, S* out,
                   Acc* work, ChainLayout lay, int sub) {
  CplOp<16, true> op;
  op.m = m;
  op.cols = m2;
  mono_tile(op, n, 1, reverse, inclusive, 1, 1, in, out, work, lay, sub);
}

// A one-launch scan's plan: padded order, columns a group, groups, the
// elements of a team, its maps' and states' sizes and its shared memory.
struct MonoPlan {
  int P, rc, groups, sub, map, state;
  long long smem;
};

template <class Op>
inline void mono_fill(MonoPlan& p, int comps, int bytes) {
  p.sub = mono_sub<Op>(comps, bytes);
  p.map = Op::kMap;
  p.state = Op::kState;
  p.smem = mono_fixed_bytes<Op>() + (long long)comps * (kMonoTeams * p.sub * bytes + 16) + 16;
}

inline MonoPlan mono_plan(const GSpec& s, int bytes) {
  MonoPlan p;
  p.P = s.kind == gCpl || s.m > 8 ? 16 : 8;
  p.rc = s.kind == gAff ? (s.r <= kAffCols8 ? kAffCols8 : kAffCols16) : 1;
  p.groups = (s.r + p.rc - 1) / p.rc;
  const int cols = s.r < p.rc ? s.r : p.rc, m = s.m;
  if (s.kind == gCpl) {
    mono_fill<CplOp<16, true>>(p, m * m + s.m2 * s.m2 + m * s.m2, bytes);
  } else if (s.kind == gRic) {
    if (p.P == 8) mono_fill<RicOp<8>>(p, 1 + 2 * m + m * m, bytes);
    else mono_fill<RicOp<16>>(p, 1 + 2 * m + m * m, bytes);
  } else if (s.kind == gCong) {
    if (p.P == 8) mono_fill<CongOp<8, true>>(p, 2 * m * m, bytes);
    else mono_fill<CongOp<16, true>>(p, 2 * m * m, bytes);
  } else {
    const int comps = m * m + m * cols;
    if (p.P == 8 && p.rc == 8) mono_fill<AffOp<8, 8>>(p, comps, bytes);
    else if (p.P == 8) mono_fill<AffOp<8, 16>>(p, comps, bytes);
    else if (p.rc == 8) mono_fill<AffOp<16, 8>>(p, comps, bytes);
    else mono_fill<AffOp<16, 16>>(p, comps, bytes);
  }
  return p;
}

inline ChainLayout mono_layout(const GSpec& s, long long n, int bytes) {
  const MonoPlan p = mono_plan(s, bytes);
  const long long tile = kMonoTeams * p.sub;
  return ChainLayout((n + tile - 1) / tile, p.groups, p.map, p.state, kMonoGroup);
}

// One memset (the ticket and the flags) and one launch, on stream st.
template <typename S>
cudaError_t mono_run(const GSpec& s, long long n, int reverse, int inclusive, const GIn<S>& in,
                     S* out, Acc* work, const ChainLayout& lay, cudaStream_t st) {
  const MonoPlan p = mono_plan(s, (int)sizeof(S));
  if (p.smem > kGenSharedBlock || lay.nt * p.groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(work + lay.flags, 0, lay.flag_words * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(lay.nt * p.groups));
  const int threads = 32 * kMonoTeams;
  if (s.kind == gCpl)
    return g_launch(cpl_tc_tile_kernel<S>, grid, threads, p.smem, st, s.m, s.m2, n, reverse,
                    inclusive, in, out, work, lay, p.sub);
  if (s.kind == gRic)
    return p.P == 8 ? g_launch(ric_tile_kernel<8, S>, grid, threads, p.smem, st, s.m, n, in, out,
                               work, lay, p.sub)
                    : g_launch(ric_tile_kernel<16, S>, grid, threads, p.smem, st, s.m, n, in, out,
                               work, lay, p.sub);
  if (s.kind == gCong)
    return p.P == 8 ? g_launch(cong_tile_kernel<8, S>, grid, threads, p.smem, st, s.m, n, reverse,
                               inclusive, in, out, work, lay, p.sub)
                    : g_launch(cong_tile_kernel<16, S>, grid, threads, p.smem, st, s.m, n, reverse,
                               inclusive, in, out, work, lay, p.sub);
#define AFF_RUN(P, RC)                                                                       \
  return g_launch(aff_tile_kernel<P, RC, S>, grid, threads, p.smem, st, s.m, n, s.r, reverse, \
                  inclusive, p.groups, in, out, work, lay, p.sub)
  if (p.P == 8 && p.rc == 8) AFF_RUN(8, 8);
  if (p.P == 8) AFF_RUN(8, 16);
  if (p.rc == 8) AFF_RUN(16, 8);
  AFF_RUN(16, 16);
#undef AFF_RUN
}

// Workspace of a scan, in Acc: the larger of the two storage types' layouts
// (their tiles differ); -1 for what no kernel here takes (the orders that
// quasisep_scan.cu's templates and quasisep_wide.cu take).
inline long long workspace_elems(const GSpec& s, long long n) {
  long long a, b;
  if (cpl_one_launch(s)) {
    a = cpl_layout(s, n, 4).total;
    b = cpl_layout(s, n, 8).total;
  } else if (mono_one_launch(s)) {
    a = mono_layout(s, n, 4).total;
    b = mono_layout(s, n, 8).total;
  } else {
    return -1;
  }
  return a > b ? a : b;
}

template <typename S>
int scan(int kind, int m, int m2, long long n, int r, int reverse, int inclusive,
         const S* x0, const S* x1, const S* x2, const S* x3, S* out, Acc* work,
         long long work_elems, void* stream) {
  if (!g_valid(kind, m, m2, n, r)) return (int)cudaErrorInvalidValue;
  const GSpec s = g_spec(kind, m, m2, r);
  const long long need = workspace_elems(s, n);
  if (need < 0 || work_elems < need) return (int)cudaErrorInvalidValue;
  const GIn<S> in{x0, x1, x2, x3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cpl_one_launch(s)) {
    const ChainLayout lay = cpl_layout(s, n, (int)sizeof(S));
    if (lay.nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return (int)cpl_run<S>(s, n, reverse, inclusive, in, out, work, lay, st);
  }
  return (int)mono_run<S>(s, n, reverse, inclusive, in, out, work, mono_layout(s, n, (int)sizeof(S)),
                          st);
}

}  // namespace

extern "C" {

// Workspace of a scan, in float64 elements; -1 for what this source does not
// take (quasisep_scan.cu's orders). kind: 0 affine, 1 congruence, 2 Riccati,
// 3 coupling; m2 is the coupling's second order (m for the other kinds); r
// the affine columns.
long long qsg_workspace_elems(int kind, int m, int m2, long long n, int r) {
  if (!g_valid(kind, m, m2, n, r)) return -1;
  return workspace_elems(g_spec(kind, m, m2, r), n);
}

// A coupling's association for operands of `bytes` bytes: elements per
// tile and per team into tile[0], sub[0]; returns 0, or -1 where this
// source does not take the orders.
int qsg_cpl_schedule(int m, int m2, int bytes, int* tile, int* sub) {
  if (!g_valid(gCpl, m, m2, 1, 1) || (bytes != 4 && bytes != 8)) return -1;
  const GSpec s = g_spec(gCpl, m, m2, 1);
  if (cpl_one_launch(s)) {
    *sub = cpl_sub(m, m2, bytes);
    *tile = kCplTeams * *sub;
  } else if (mono_one_launch(s)) {
    *sub = mono_plan(s, bytes).sub;
    *tile = kMonoTeams * *sub;
  } else {
    return -1;
  }
  return 0;
}

// The Riccati, affine or congruence scan's association above m = 4 for
// operands of `bytes` bytes: elements per tile, per team and affine columns
// per group into tile[0], sub[0], cols[0]; returns 0, or -1 where this
// source does not take the scan.
int qsg_scan_schedule(int kind, int m, int r, int bytes, int* tile, int* sub, int* cols) {
  if (!g_valid(kind, m, m, 1, r) || kind == gCpl || (bytes != 4 && bytes != 8)) return -1;
  const GSpec s = g_spec(kind, m, m, r);
  if (!mono_one_launch(s)) return -1;
  const MonoPlan p = mono_plan(s, bytes);
  *sub = p.sub;
  *tile = kMonoTeams * p.sub;
  *cols = p.rc;
  return 0;
}

// One scan into out. Operands by kind: affine (A, B), congruence (A, B),
// Riccati (d, ps, qs, as), coupling (A, B, C); unused pointers are null.
// Returns a cudaError_t code: nonzero if an argument is refused or a
// launch failed.
int qsg_scan_f32(int kind, int m, int m2, long long n, int r, int reverse,
                 int inclusive, const float* x0, const float* x1,
                 const float* x2, const float* x3, float* out, double* work,
                 long long work_elems, void* stream) {
  return scan<float>(kind, m, m2, n, r, reverse, inclusive, x0, x1, x2, x3, out,
                     work, work_elems, stream);
}

int qsg_scan_f64(int kind, int m, int m2, long long n, int r, int reverse,
                 int inclusive, const double* x0, const double* x1,
                 const double* x2, const double* x3, double* out, double* work,
                 long long work_elems, void* stream) {
  return scan<double>(kind, m, m2, n, r, reverse, inclusive, x0, x1, x2, x3,
                      out, work, work_elems, stream);
}

const char* qsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
