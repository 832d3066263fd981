// Kernel B3, the generic monoid scan, at every order on Hopper (sm_90a).
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_scan.py:
// _scan_kernel (line 331), launched by pallas_monoid_scan (line 405), for
// the orders quasisep_scan.cu's templates do not take: the affine,
// congruence and Riccati monoids with 4 < m <= 32 and the coupling of any
// pair of orders up to 32 other than two equal orders up to 4. The TPU
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
// The coupling g' = A g B^T + C with max(m, m2) <= kCplMaxM (Matern52's
// (6, 6) and the 2-term celerite's (8, 8) on the conditioning path) runs in
// one launch and one memset of its flags: cpl_tile_kernel below, B2's warp
// design (quasisep_loglik_generic.cu: b2_warp_kernel) run forwards. Every
// other scan runs quasisep_generic.cuh's three-phase engine, whose entries
// this file's C interface also is.
//
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

#include "quasisep_generic.cuh"

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

// By warp 0: publish `size` values of src at dst, then set *flag to v.
__device__ __forceinline__ void cpl_publish(const Acc* src, Acc* dst, int size, unsigned* flag,
                                            unsigned v) {
  for (int c = threadIdx.x; c < size; c += 32) dst[c] = src[c];
  __threadfence();
  __syncwarp();
  if (threadIdx.x == 0) st_release(flag, v);
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
    if (!end && more) cpl_publish(agg, sl.tile_agg + b * kCplMap, kCplMap, sl.tile_flag + b, 1u);
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
    cpl_publish(GA, sl.group_agg + g * kCplMap, kCplMap, sl.group_flag + g, 1u);
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
    cpl_publish(s, sl.group_state + g * kCplPad, kCplPad, sl.group_flag + g, 2u);
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

// Workspace of a scan, in Acc; for the one-launch coupling the larger of
// the two storage types' layouts (their tiles differ).
inline long long workspace_elems(const GSpec& s, long long n) {
  if (!cpl_one_launch(s)) return g_workspace_elems(s, n);
  const long long a = cpl_layout(s, n, 4).total, b = cpl_layout(s, n, 8).total;
  return a > b ? a : b;
}

template <typename S>
int scan(int kind, int m, int m2, long long n, int r, int reverse, int inclusive,
         const S* x0, const S* x1, const S* x2, const S* x3, S* out, Acc* work,
         long long work_elems, void* stream) {
  if (!g_valid(kind, m, m2, n, r)) return (int)cudaErrorInvalidValue;
  const GSpec s = g_spec(kind, m, m2, r);
  if (work_elems < workspace_elems(s, n)) return (int)cudaErrorInvalidValue;
  const GIn<S> in{x0, x1, x2, x3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cpl_one_launch(s)) {
    const ChainLayout lay = cpl_layout(s, n, (int)sizeof(S));
    if (lay.nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return (int)cpl_run<S>(s, n, reverse, inclusive, in, out, work, lay, st);
  }
  return (int)g_run<S, S>(s, n, reverse, inclusive, in, out, work, st);
}

}  // namespace

extern "C" {

// Workspace of a scan, in float64 elements; -1 for what the engine does not
// take. kind: 0 affine, 1 congruence, 2 Riccati, 3 coupling; m2 is the
// coupling's second order (m for the other kinds); r the affine columns.
long long qsg_workspace_elems(int kind, int m, int m2, long long n, int r) {
  if (!g_valid(kind, m, m2, n, r)) return -1;
  return workspace_elems(g_spec(kind, m, m2, r), n);
}

// The one-launch coupling's association for operands of `bytes` bytes:
// elements per tile and per team into tile[0], sub[0]; returns 0, or -1
// where the orders run the three-phase engine.
int qsg_cpl_schedule(int m, int m2, int bytes, int* tile, int* sub) {
  if (!g_valid(gCpl, m, m2, 1, 1) || !cpl_one_launch(g_spec(gCpl, m, m2, 1)) ||
      (bytes != 4 && bytes != 8))
    return -1;
  *sub = cpl_sub(m, m2, bytes);
  *tile = kCplTeams * *sub;
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
