// The generic-order monoid scan engine on Hopper (sm_90a): kernel B3 at
// every order of the quasiseparable algebra, the scans of B1 and B1r above
// m = 4 and those of B2 above m = 8 (B2 runs in one launch up to m = 8,
// quasisep_loglik_generic.cu: b2_warp_kernel). Included by
// quasisep_generic.cu (B3's entries) and quasisep_loglik_generic.cu.
//
// Why not quasisep_scan.cu's kernel at a larger m. There each thread keeps
// one monoid value in registers and a Kogge-Stone pass runs over a shared
// array of every thread's value (quasisep_common.cuh). One Riccati value is
// 3 m^2 doubles: 6 KB at m = 16, so a 64-thread block would need 393 KB of
// shared memory against the 227 KB a block may have, and the values spill
// out of registers long before that.
//
// Design. The order is a run-time argument: m for the affine, congruence
// and Riccati monoids, (m, m2) for the coupling. One team of threads owns
// one chunk of consecutive elements and walks it in sequence; its threads
// share each matrix product, about one output entry per thread
// (quasisep_common.cuh: gmm), with the running value, the element and the
// scratch in shared memory. A team is a whole block, or for the Riccati
// flow and the affine scan with one column at m <= kWarpTeamMaxM one warp,
// several chunks to a block, whose products need only __syncwarp. Three phases, as in the m <= 4 kernels:
//
//   1. the chunk pass: each team folds its chunk into one monoid value.
//      The affine, congruence and coupling monoids compose with the full
//      combine (g_chunk_pass; aff_chunk_pass for a warp team). The Riccati flow folds each element with
//      the rank-one step (ric_chunk_pass, below), no inverse;
//   2. g_totals_pass: a Hillis-Steele scan of the chunk totals, one launch
//      per doubling (ceil(log2 nb) launches), each team merging two totals
//      from device memory with the full combine (for the Riccati flow the
//      Moebius merge through a pivoted inverse of I + F G);
//   3. the finish pass: each team starts from the state its prefix gives
//      (the leaf of the inclusive total of the chunks before it; the flow
//      starts at 0) and walks its chunk with the sequential recurrence,
//      writing the state before (exclusive) or after (inclusive) each
//      element (g_finish_pass; ric_finish_pass for the Riccati flow,
//      which for B1 writes the Cholesky emission of the same step in
//      place of the state: RicEmit).
//
// Phase 3 steps the state and does not compose maps: A g + B per affine
// column, A g A^T + B, A g B^T + C, and the Riccati step
// F' = a F a^T + u u^T / c2 (as quasisep_loglik.cu does), so the chunks run
// another algorithm than the merges and agreement with the plain blocked
// scan checks the algorithm and not only the code.
//
// The Riccati chunk fold. The flow's element is rank-one: A = a - q p^T / d,
// F = q q^T / d, G = -p p^T / d (g_combine's Moebius map). Merged after a
// running value (A, F, G), Sherman-Morrison turns the inverse of
// I + F G_l = I - f p^T / d, with f = F p, into I + f p^T / c with the
// chunk-local Schur complement c = d - p^T f (positive for a positive
// definite K), and the merge into
//
//   A' = a A - u w^T / c,  F' = a F a^T + u u^T / c,  G' = G - w w^T / c,
//
// with u = q - a f and w = A^T p: about 3 m^3 multiply-adds and three team
// barriers an element, against the full merge's 10 m^3, its inverse and
// about 2 m + 10 barriers. Starting from the identity (A = I, F = G = 0),
// the first element's fold is the element itself.
// solvers/quasisep/scan.py:riccati_fold_rank_one is its plain version.
//
// The affine scan's r columns share the transitions; a block takes a group
// of rc columns (grid y), so a value is m^2 + m rc wide. A reverse scan
// mirrors the index, as in quasisep_scan.cu. Every combine and step runs in
// float64 (Acc) whatever the operands' type (see quasisep_loglik.cu,
// Precision); the output is stored in its own type, which may differ from
// the operands' (B1 keeps its Riccati state in float64).
//
// What bounds it: the float64 arithmetic (the Riccati fold and step about
// 3 and 2 m^3 multiply-adds an element) and the team barriers between the
// products. The cost of this design against the bound: an element's
// components lie n apart (component c of element k at [c * n + k]); a
// warp team stages them kRicBatch elements at a time with cp.async, so a
// warp's copies of one component are consecutive, and gathers its
// outputs the same way, while a block team loads one element ahead into
// registers; every product waits on a barrier; the congruence and coupling
// scans, and the affine scans with more columns or above kWarpTeamMaxM, run
// a block per chunk and compose full maps.

#pragma once

#include "quasisep_common.cuh"

namespace {

enum GKind { gAff = 0, gCong = 1, gRic = 2, gCpl = 3 };

constexpr int kGenMaxM = 32;          // largest order the engine takes
constexpr int kGenThreads = 256;      // most threads of a block
constexpr long long kGenMinChunk = 4;
constexpr long long kGenSharedBlock = 232448;  // 227 KB, a block on sm_90
constexpr long long kGenSharedSM = 233472;     // 228 KB per multiprocessor
constexpr int kWarpTeamMaxM = 8;      // warp teams (Riccati; affine, one column) up to here
constexpr int kWarpTeams = 4;         // warp teams (chunks) per block
constexpr int kRicWarpTeamsPerSM = 16;  // Riccati chunks aimed for per multiprocessor
constexpr long long kRicMinChunk = 8;

// One scan's monoid and order: m2 is the coupling's second order (m for the
// other monoids), r the affine scan's columns and rc the columns a block
// takes (1 for the other monoids).
struct GSpec {
  int kind, m, m2, r, rc;
};

template <typename S>
struct GIn {
  const S* x0;
  const S* x1;
  const S* x2;
  const S* x3;
};

// Columns of the affine group g (the last group may be narrower).
__host__ __device__ inline int g_cols(const GSpec& s, int group) {
  if (s.kind != gAff) return 1;
  const int left = s.r - group * s.rc;
  return left < s.rc ? left : s.rc;
}

// Components of one monoid value with c affine columns:
// [A | B] (m^2 + m c), [A | B] (2 m^2), [A | F | G] (3 m^2) or
// [A (m x m) | B (m2 x m2) | C (m x m2)].
__host__ __device__ inline int g_size(const GSpec& s, int c) {
  const int mm = s.m * s.m;
  switch (s.kind) {
    case gAff: return mm + s.m * c;
    case gCong: return 2 * mm;
    case gRic: return 3 * mm;
    default: return mm + s.m2 * s.m2 + s.m * s.m2;
  }
}

// Offset of the leaf, the state the scan outputs (B, B, F or C).
__host__ __device__ inline int g_leaf(const GSpec& s) {
  return s.kind == gCpl ? s.m * s.m + s.m2 * s.m2 : s.m * s.m;
}

// Entries of the state: m x c, m x m, m x m or m x m2.
__host__ __device__ inline int g_state_size(const GSpec& s, int c) {
  switch (s.kind) {
    case gAff: return s.m * c;
    case gCpl: return s.m * s.m2;
    default: return s.m * s.m;
  }
}

// Scratch of the combine and the state step, in Acc. The Riccati merge
// needs [M | M^-1] (2 m^2), two products (2 m^2) and the inverse's 5 m.
__host__ __device__ inline int g_scratch(const GSpec& s) {
  const int m = s.m;
  switch (s.kind) {
    case gAff: return 1;
    case gCong: return m * m;
    case gRic: return 4 * m * m + 5 * m;
    default: return m * s.m2;
  }
}

__device__ __forceinline__ long long g_element_index(long long pos, long long n, int reverse) {
  return reverse ? n - 1 - pos : pos;
}

// ---------------------------------------------------------------- block ops
//
// All block-cooperative (g_element, g_step: the block is the team) or
// team-cooperative (g_combine): every thread of the team calls them, and
// each ends with the team's barrier.

// Element k of the affine, congruence or coupling scan as a monoid value
// in v (the Riccati flow's elements are read by RicLoad).
template <typename S>
__device__ __forceinline__ void g_element(const GSpec& s, int c, int col0, long long n,
                                          const GIn<S>& in, long long k, Acc* v) {
  const int m = s.m, mm = m * m, t = threadIdx.x, nt = blockDim.x;
  switch (s.kind) {
    case gAff:
      for (int i = t; i < mm; i += nt) v[i] = Acc(in.x0[i * n + k]);
      for (int i = t; i < m * c; i += nt) {
        const int row = i / c, col = i - row * c;
        v[mm + i] = Acc(in.x1[((long long)row * s.r + col0 + col) * n + k]);
      }
      break;
    case gCong:
      for (int i = t; i < mm; i += nt) {
        v[i] = Acc(in.x0[i * n + k]);
        v[mm + i] = Acc(in.x1[i * n + k]);
      }
      break;
    default: {
      const int m2s = s.m2 * s.m2, mc = m * s.m2;
      for (int i = t; i < mm; i += nt) v[i] = Acc(in.x0[i * n + k]);
      for (int i = t; i < m2s; i += nt) v[mm + i] = Acc(in.x1[i * n + k]);
      for (int i = t; i < mc; i += nt) v[mm + m2s + i] = Acc(in.x2[i * n + k]);
    }
  }
  __syncthreads();
}

// out = combine(e, l): the earlier value e, then the later l. out aliases
// neither. scr: g_scratch(s) values; piv: one int. M > 0 is s.m as a
// compile-time constant.
template <int M, class Team>
__device__ void g_combine(const Team& tm, const GSpec& s, int c, const Acc* e, const Acc* l,
                          Acc* out, Acc* scr, int* piv) {
  const int m = M > 0 ? M : s.m, mm = m * m;
  switch (s.kind) {
    case gAff:
      // (A_l A_e, A_l B_e + B_l)
      gmm(tm, m, m, m, l, m, false, e, m, false, out, m);
      gmm(tm, m, m, c, l, m, false, e + mm, c, false, out + mm, c, l + mm, c);
      break;
    case gCong:
      // (A_l A_e, A_l B_e A_l^T + B_l)
      gmm(tm, m, m, m, l, m, false, e, m, false, out, m);
      gmm(tm, m, m, m, l, m, false, e + mm, m, false, scr, m);
      gmm(tm, m, m, m, scr, m, false, l, m, true, out + mm, m, l + mm, m);
      break;
    case gCpl: {
      // (A_l A_e, B_l B_e, A_l C_e B_l^T + C_l)
      const int m2 = s.m2, ob = mm, oc = mm + m2 * m2;
      gmm(tm, m, m, m, l, m, false, e, m, false, out, m);
      gmm(tm, m2, m2, m2, l + ob, m2, false, e + ob, m2, false, out + ob, m2);
      gmm(tm, m, m, m2, l, m, false, e + oc, m2, false, scr, m2);
      gmm(tm, m, m2, m2, scr, m2, false, l + ob, m2, true, out + oc, m2, l + oc, m2);
      break;
    }
    default: {
      // M = I + F_e G_l;  A = A_l M^-1 A_e;  F = F_l + A_l M^-1 F_e A_l^T;
      // G = G_e + A_e^T M^-T G_l A_e (scan.py:_riccati_scan_s).
      const Acc *Ae = e, *Fe = e + mm, *Ge = e + 2 * mm;
      const Acc *Al = l, *Fl = l + mm, *Gl = l + 2 * mm;
      Acc* W = scr;
      Acc* Minv = scr + m;
      Acc* t1 = scr + 2 * mm;
      Acc* t2 = scr + 3 * mm;
      gmm<M>(tm, m, m, m, Fe, m, false, Gl, m, false, W, 2 * m);
      for (int i = tm.rank(); i < m; i += tm.size()) W[i * (2 * m) + i] += Acc(1);
      tm.sync();
      ginverse(tm, m, W, scr + 4 * mm, piv);
      gmm<M>(tm, m, m, m, Minv, 2 * m, false, Ae, m, false, t1, m);
      gmm<M>(tm, m, m, m, Al, m, false, t1, m, false, out, m);
      gmm<M>(tm, m, m, m, Minv, 2 * m, false, Fe, m, false, t1, m);
      gmm<M>(tm, m, m, m, Al, m, false, t1, m, false, t2, m);
      gmm<M>(tm, m, m, m, t2, m, false, Al, m, true, out + mm, m, Fl, m);
      gmm<M>(tm, m, m, m, Minv, 2 * m, true, Gl, m, false, t1, m);
      gmm<M>(tm, m, m, m, Ae, m, true, t1, m, false, t2, m);
      gmm<M>(tm, m, m, m, t2, m, false, Ae, m, false, out + 2 * mm, m, Ge, m);
    }
  }
}

// The state after element k of the affine, congruence or coupling scan,
// from the state g before it, into nw. x holds the element; t is scratch.
template <typename S>
__device__ __forceinline__ void g_step(const GSpec& s, int c, int col0, long long n,
                                       const GIn<S>& in, long long k, const Acc* g, Acc* nw,
                                       Acc* x, Acc* t) {
  const BlockTeam tm;
  const int m = s.m, mm = m * m;
  g_element(s, c, col0, n, in, k, x);
  switch (s.kind) {
    case gAff:
      // A g + B
      gmm(tm, m, m, c, x, m, false, g, c, false, nw, c, x + mm, c);
      break;
    case gCong:
      // A g A^T + B
      gmm(tm, m, m, m, x, m, false, g, m, false, t, m);
      gmm(tm, m, m, m, t, m, false, x, m, true, nw, m, x + mm, m);
      break;
    default: {
      // A g B^T + C
      const int m2 = s.m2, ob = mm, oc = mm + m2 * m2;
      gmm(tm, m, m, m2, x, m, false, g, m2, false, t, m2);
      gmm(tm, m, m2, m2, t, m2, false, x + ob, m2, true, nw, m2, x + oc, m2);
    }
  }
}

// Write the state g as element k's output (no barrier: g is only read).
template <class Team, typename O>
__device__ __forceinline__ void g_store(const Team& tm, const GSpec& s, int c, int col0,
                                        long long n, O* out, long long k, const Acc* g) {
  const int t = tm.rank(), nt = tm.size();
  if (s.kind == gAff) {
    for (int i = t; i < s.m * c; i += nt) {
      const int row = i / c, col = i - row * c;
      out[((long long)row * s.r + col0 + col) * n + k] = O(g[i]);
    }
  } else {
    const int size = g_state_size(s, c);
    for (int i = t; i < size; i += nt) out[i * n + k] = O(g[i]);
  }
}

// ------------------------------------------------------ the Riccati flow
//
// A Riccati element's components, in the order its operands hold them:
// [d | p (m) | q (m) | a (m x m)], 1 + 2m + m^2 values.
__host__ __device__ inline int ric_elem_size(int m) { return 1 + 2 * m + m * m; }

// Elements a warp team stages per batch: one 32-byte sector of each
// component (float32), so that its loads are coalesced.
constexpr int kRicBatch = 8;

// A staged element's row: odd, so that the batch's elements of one
// component fall in distinct banks.
__host__ __device__ inline int ric_stage_stride(int m) { return ric_elem_size(m) | 1; }
// The finish pass's row of outputs per element: the state F (m^2), or
// with B1's emission the whitening transition a - w p^T (m^2), w = u / c2
// (m), c2 and the state F (m^2).
__host__ __device__ inline int ric_state_stride(int m) { return (2 * m * m + m + 1) | 1; }

// Bytes of one Riccati team's shared values (RicTeam), a multiple of 16:
// in Acc the running value [A | F | G], the products a F and a A, f, w, u
// and two element buffers; for a warp team also the batch of elements in
// Acc, the finish pass's batch of outputs, and two batches of the operands
// for cp.async (room for float64 operands); for a block team one row of
// outputs. The totals pass's merge scratch (g_scratch, and the pivot) fits
// in the same room.
__host__ __device__ inline long long ric_team_bytes(int m, bool warp) {
  long long bytes = (5LL * m * m + 3 * m + 2LL * ric_elem_size(m)) * sizeof(Acc);
  if (warp)
    bytes += (long long)kRicBatch * (3 * ric_stage_stride(m) + ric_state_stride(m)) * sizeof(Acc);
  else
    bytes += (long long)ric_state_stride(m) * sizeof(Acc);
  return (bytes + 15) / 16 * 16;
}

// One thread's share of an element's components, loaded into registers
// ahead of its use so that the loads' latency hides behind the team's
// work on the element before (the block teams; warp teams stage batches).
// A block team has at least m^2 threads: at most 1089 components at
// m = 32 over 256 threads, kRicPre a thread.
constexpr int kRicPre = 8;

template <typename S, int kPre>
struct RicLoad {
  Acc v[kPre];

  __device__ void load(const GIn<S>& in, int m, long long n, long long k, int rank, int size) {
    const int total = ric_elem_size(m);
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int c = rank + j * size;
      if (c < total) {
        if (c == 0)
          v[j] = Acc(in.x0[k]);
        else if (c <= m)
          v[j] = Acc(in.x1[(long long)(c - 1) * n + k]);
        else if (c <= 2 * m)
          v[j] = Acc(in.x2[(long long)(c - 1 - m) * n + k]);
        else
          v[j] = Acc(in.x3[(long long)(c - 1 - 2 * m) * n + k]);
      }
    }
  }

  __device__ void store(Acc* E, int m, int rank, int size) const {
    const int total = ric_elem_size(m);
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int c = rank + j * size;
      if (c < total) E[c] = v[j];
    }
  }
};

// The team's shared values.
template <typename S>
struct RicTeam {
  Acc *A, *F, *G, *T1, *T2, *f, *w, *u, *E0, *E1, *ast, *ost;
  S* sst;

  __device__ RicTeam(unsigned char* base, int m, bool warp) {
    const int mm = m * m, es = ric_elem_size(m);
    A = reinterpret_cast<Acc*>(base);
    F = A + mm;
    G = F + mm;
    T1 = G + mm;
    T2 = T1 + mm;
    f = T2 + mm;
    w = f + m;
    u = w + m;
    E0 = u + m;
    E1 = E0 + es;
    ast = E1 + es;
    ost = warp ? ast + kRicBatch * ric_stage_stride(m) : ast;
    sst = reinterpret_cast<S*>(ost + kRicBatch * ric_state_stride(m));
  }
};

// B1's outputs of the Riccati flow's finish pass, in place of the states:
// for each element k the whitening transition A = a - w p^T (m^2, n) and
// load B = w y (m, n), w = u / c2, the pivot c2 (n), all in Acc, and with
// Fs the exclusive state F in the operands' type (B1r's residual).
template <typename S>
struct RicEmit {
  const S* y;
  Acc *A, *B, *c2;
  S* Fs;
};

// Copy the cnt elements from position pos0 on into dst (element j's
// component c, of `total`, at dst[j * stride + c]; src(c, k) points at
// component c of element k) asynchronously, component by component, so
// that a warp's copies of one component are consecutive in memory; then
// commit them as one group.
template <typename S, class Team, class Src>
__device__ void team_stage(const Team& tm, int total, int stride, long long n, int reverse,
                           long long pos0, int cnt, S* dst, Src src) {
  for (int idx = tm.rank(); idx < total * kRicBatch; idx += tm.size()) {
    const int c = idx / kRicBatch, j = idx - c * kRicBatch;
    if (j < cnt) cp_async_elem(dst + j * stride + c, src(c, g_element_index(pos0 + j, n, reverse)));
  }
  cp_async_commit();
}

// A warp team's walk over its chunk [lo, hi) of elements of `total`
// components: batches of kRicBatch elements staged in sst (two batches,
// the next one's copies in flight while the team works on the current
// one) and converted to Acc in ast; step(j, E) for the batch's element j,
// E its components, and flush(base, cnt) once the batch is done.
template <typename S, class Team, class Src, class Step, class Flush>
__device__ void team_walk(const Team& tm, int total, int stride, Acc* ast, S* sst, long long n,
                          int reverse, long long lo, long long hi, Src src, Step step,
                          Flush flush) {
  const int half = kRicBatch * stride;
  const auto batch = [&](long long base) {
    return (int)(hi - base < kRicBatch ? hi - base : kRicBatch);
  };
  team_stage(tm, total, stride, n, reverse, lo, batch(lo), sst, src);
  int cur = 0;
  for (long long base = lo; base < hi; base += kRicBatch, cur ^= 1) {
    const int cnt = batch(base);
    const long long next = base + kRicBatch;
    if (next < hi)
      team_stage(tm, total, stride, n, reverse, next, batch(next), sst + (cur ^ 1) * half, src);
    else
      cp_async_commit();
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    tm.sync();
    const S* staged = sst + cur * half;
    for (int idx = tm.rank(); idx < cnt * stride; idx += tm.size()) ast[idx] = Acc(staged[idx]);
    tm.sync();
    for (int j = 0; j < cnt; ++j) step(j, ast + j * stride);
    tm.sync();
    flush(base, cnt);
  }
}

// Component c of the Riccati element k: [d | p | q | a].
template <typename S>
struct RicSrc {
  GIn<S> in;
  int m;
  long long n;
  __device__ const S* operator()(int c, long long k) const {
    return c == 0       ? in.x0 + k
           : c <= m     ? in.x1 + (long long)(c - 1) * n + k
           : c <= 2 * m ? in.x2 + (long long)(c - 1 - m) * n + k
                        : in.x3 + (long long)(c - 1 - 2 * m) * n + k;
  }
};

// One element E = [d | p | q | a] folded into the team's running value:
// with kFull the chunk fold (A, F, G), else the finish pass's step of the
// state F alone. Leaves the new value's last writes unsynchronized (the
// caller's barrier follows). M > 0 is the order as a compile-time
// constant, so that the products' loops unroll.
template <bool kFull, int M, class Team, class R>
__device__ __forceinline__ void ric_fold(const Team& tm, int m_run, const R& r, const Acc* E,
                                         Acc* emit = nullptr) {
  const int m = M > 0 ? M : m_run, mm = m * m, t = tm.rank(), nt = tm.size();
  const Acc* p = E + 1;
  const Acc* q = p + m;
  const Acc* a = q + m;
  // T1 = a F and, for the fold, T2 = a A, an entry a thread (both share
  // the row of a); then f = F p and, for the fold, w = A^T p, one dot
  // product a thread through a pointer and a stride, so that a warp's
  // threads take one path.
  for (int e = t; e < mm; e += nt) {
    const int i = e / m, j = e - i * m;
    Acc t1 = Acc(0), t2 = Acc(0);
#pragma unroll
    for (int l = 0; l < m; ++l) {
      const Acc ail = a[i * m + l];
      t1 += ail * r.F[l * m + j];
      if (kFull) t2 += ail * r.A[l * m + j];
    }
    r.T1[e] = t1;
    if (kFull) r.T2[e] = t2;
  }
  for (int i = t; i < (kFull ? 2 * m : m); i += nt) {
    const bool fi = i < m;
    const Acc* x = fi ? r.F + i * m : r.A + (i - m);
    const int step = fi ? 1 : m;
    Acc acc = Acc(0);
#pragma unroll
    for (int l = 0; l < m; ++l) acc += x[l * step] * p[l];
    (fi ? r.f : r.w)[fi ? i : i - m] = acc;
  }
  tm.sync();
  // u = q - a f.
  for (int i = t; i < m; i += nt) {
    Acc acc = q[i];
#pragma unroll
    for (int l = 0; l < m; ++l) acc -= a[i * m + l] * r.f[l];
    r.u[i] = acc;
  }
  tm.sync();
  // c = d - p^T f, the chunk-local Schur complement (every thread alike).
  Acc c2 = E[0];
#pragma unroll
  for (int l = 0; l < m; ++l) c2 -= p[l] * r.f[l];
  const Acc ic = Acc(1) / c2;
  // F' = (a F) a^T + u u^T / c; A' = a A - u w^T / c; G' = G - w w^T / c,
  // the three entries (i, j) by one thread.
  for (int e = t; e < mm; e += nt) {
    const int i = e / m, j = e - i * m;
    Acc acc = Acc(0);
#pragma unroll
    for (int l = 0; l < m; ++l) acc += r.T1[i * m + l] * a[j * m + l];
    const Acc ui = r.u[i];
    r.F[e] = acc + ui * r.u[j] * ic;
    if (!kFull && emit) emit[e] = a[e] - ui * ic * p[j];
    if (kFull) {
      const Acc wj = r.w[j];
      r.A[e] = r.T2[e] - ui * wj * ic;
      r.G[e] -= r.w[i] * wj * ic;
    }
  }
  // With the emission row: w = u / c2 and c2 after the transition.
  if (!kFull && emit) {
    for (int i = t; i < m; i += nt) emit[mm + i] = r.u[i] * ic;
    if (t == 0) emit[mm + m] = c2;
  }
}

// The team owning chunk `chunk` of the block, and its shared values.
template <class Team>
__device__ inline long long ric_chunk_index(int teams) {
  return Team::kWarp ? (long long)blockIdx.x * teams + threadIdx.x / 32 : blockIdx.x;
}

template <class Team>
__device__ inline unsigned char* ric_team_base(long long team_bytes) {
  return qsl_smem + (Team::kWarp ? (threadIdx.x / 32) * team_bytes : 0);
}

// Phase 1 for the Riccati flow: each team folds its chunk, from the
// identity, with the rank-one step; the chunk's total [A | F | G] goes to
// tot.
template <typename S, class Team, int M>
__global__ void __launch_bounds__(kGenThreads)
ric_chunk_pass(GSpec s, long long n, long long chunk, long long nb, int teams, int team_bytes,
               int reverse, GIn<S> in, Acc* tot) {
  const Team tm;
  const long long b = ric_chunk_index<Team>(teams);
  if (b >= nb) return;  // a whole warp team: no block barrier follows
  const int m = M > 0 ? M : s.m, mm = m * m, t = tm.rank(), nt = tm.size();
  const RicTeam<S> r(ric_team_base<Team>(team_bytes), m, Team::kWarp);
  const long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  for (int i = t; i < 3 * mm; i += nt) {
    const int e = i % mm;
    r.A[i] = i < mm && e / m == e % m ? Acc(1) : Acc(0);
  }
  if constexpr (Team::kWarp) {
    tm.sync();
    team_walk(tm, ric_elem_size(m), ric_stage_stride(m), r.ast, r.sst, n, reverse, lo, hi,
              RicSrc<S>{in, m, n},
              [&](int, const Acc* E) {
                ric_fold<true, M>(tm, m, r, E);
                tm.sync();
              },
              [](long long, int) {});
  } else {
    RicLoad<S, kRicPre> next;
    next.load(in, m, n, g_element_index(lo, n, reverse), t, nt);
    next.store(r.E0, m, t, nt);
    tm.sync();
    for (long long pos = lo; pos < hi; ++pos) {
      const bool odd = (pos - lo) & 1;
      if (pos + 1 < hi) next.load(in, m, n, g_element_index(pos + 1, n, reverse), t, nt);
      ric_fold<true, M>(tm, m, r, odd ? r.E1 : r.E0);
      if (pos + 1 < hi) next.store(odd ? r.E0 : r.E1, m, t, nt);
      tm.sync();
    }
  }
  Acc* dst = tot + b * 3 * mm;
  for (int i = t; i < 3 * mm; i += nt) dst[i] = r.A[i];
}

// Phase 3 for the Riccati flow: each team steps the state F through its
// chunk from the prefix's leaf, writing it before (exclusive) or after
// (inclusive) each element, or with `em` B1's emission (RicEmit) from
// the same step. A warp team gathers a batch's outputs in shared memory
// and writes them once the batch is done, each output's entry for
// consecutive elements together.
template <typename S, typename O, class Team, int M>
__global__ void __launch_bounds__(kGenThreads)
ric_finish_pass(GSpec s, long long n, long long chunk, long long nb, int teams, int team_bytes,
                int reverse, int inclusive, GIn<S> in, O* out, const Acc* incl, RicEmit<S> em) {
  const Team tm;
  const long long b = ric_chunk_index<Team>(teams);
  if (b >= nb) return;
  const int m = M > 0 ? M : s.m, mm = m * m, t = tm.rank(), nt = tm.size();
  const RicTeam<S> r(ric_team_base<Team>(team_bytes), m, Team::kWarp);
  const long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const bool emit = em.A != nullptr;
  // A row's F: the whole row without the emission, after its m^2 + m + 1
  // values with it.
  const int fo = emit ? mm + m + 1 : 0, os = ric_state_stride(m);
  const int cols = emit ? (em.Fs ? 2 * mm + m + 1 : mm + m + 1) : mm;
  // Write output column col of element k (the row's value v).
  const auto put = [&](int col, long long k, Acc v) {
    if (!emit)
      out[(long long)col * n + k] = O(v);
    else if (col < mm)
      em.A[(long long)col * n + k] = v;
    else if (col < mm + m)
      em.B[(long long)(col - mm) * n + k] = v * Acc(em.y[k]);
    else if (col == mm + m)
      em.c2[k] = v;
    else
      em.Fs[(long long)(col - fo) * n + k] = S(v);
  };
  // The flow starts at 0, so the state at the chunk's start is the leaf
  // of the inclusive total of the chunks before it.
  for (int i = t; i < mm; i += nt) r.F[i] = b == 0 ? Acc(0) : incl[(b - 1) * 3 * mm + mm + i];
  if constexpr (Team::kWarp) {
    tm.sync();
    const bool keep_f = !emit || em.Fs;
    const auto keep = [&](int j) {
      if (keep_f)
        for (int i = t; i < mm; i += nt) r.ost[j * os + fo + i] = r.F[i];
    };
    const auto flush = [&](long long base, int cnt) {
      for (int idx = t; idx < cols * cnt; idx += nt) {
        const int col = idx / cnt, j = idx - col * cnt;
        put(col, g_element_index(base + j, n, reverse), r.ost[j * os + col]);
      }
    };
    const bool after = inclusive && !emit;
    team_walk(tm, ric_elem_size(m), ric_stage_stride(m), r.ast, r.sst, n, reverse, lo, hi,
              RicSrc<S>{in, m, n},
              [&](int j, const Acc* E) {
                if (!after) keep(j);
                ric_fold<false, M>(tm, m, r, E, emit ? r.ost + j * os : nullptr);
                tm.sync();
                if (after) keep(j);
              },
              flush);
  } else {
    RicLoad<S, kRicPre> next;
    next.load(in, m, n, g_element_index(lo, n, reverse), t, nt);
    next.store(r.E0, m, t, nt);
    tm.sync();
    for (long long pos = lo; pos < hi; ++pos) {
      const bool odd = (pos - lo) & 1;
      const long long k = g_element_index(pos, n, reverse);
      if (pos + 1 < hi) next.load(in, m, n, g_element_index(pos + 1, n, reverse), t, nt);
      if (!inclusive || emit) {
        if (!emit || em.Fs)
          for (int i = t; i < mm; i += nt) put(fo + i, k, r.F[i]);
      }
      ric_fold<false, M>(tm, m, r, odd ? r.E1 : r.E0, emit ? r.ost : nullptr);
      if (pos + 1 < hi) next.store(odd ? r.E0 : r.E1, m, t, nt);
      tm.sync();
      if (emit)
        for (int col = t; col < mm + m + 1; col += nt) put(col, k, r.ost[col]);
      else if (inclusive)
        for (int i = t; i < mm; i += nt) put(i, k, r.F[i]);
    }
  }
}

// ------------------------------------------ the affine scan, a warp per chunk
//
// The affine scan g' = A g + B with one column at m <= kWarpTeamMaxM (B1's
// whitening scan, B3's with r = 1), run as the Riccati
// flow runs: a warp per chunk, elements staged in batches, the order a
// compile-time constant at 5..8. The combine is g_combine's, (A_l A_e,
// A_l B_e + B_l), folded element by element, with the running value kept
// as the m x (m + 1) matrix [A | B], so that one product covers both.

__host__ __device__ inline int aff_stage_stride(int m) { return (m * m + m) | 1; }
__host__ __device__ inline int aff_state_stride(int m) { return m | 1; }

// Bytes of one affine warp team's shared values (AffTeam), a multiple of
// 16: two running values, the batch of elements in Acc, two staged batches
// and the finish pass's batch of states.
__host__ __device__ inline long long aff_team_bytes(int m) {
  const long long bytes =
      (2LL * m * (m + 1) + (long long)kRicBatch * (3 * aff_stage_stride(m) + aff_state_stride(m))) *
      sizeof(Acc);
  return (bytes + 15) / 16 * 16;
}

template <typename S>
struct AffTeam {
  Acc *V0, *V1, *ast, *ost;
  S* sst;

  __device__ AffTeam(unsigned char* base, int m) {
    V0 = reinterpret_cast<Acc*>(base);
    V1 = V0 + m * (m + 1);
    ast = V1 + m * (m + 1);
    ost = ast + kRicBatch * aff_stage_stride(m);
    sst = reinterpret_cast<S*>(ost + kRicBatch * aff_state_stride(m));
  }
};

// Component c of the affine element k: [A (m x m) | B (m)].
template <typename S>
struct AffSrc {
  GIn<S> in;
  int m;
  long long n;
  __device__ const S* operator()(int c, long long k) const {
    return c < m * m ? in.x0 + (long long)c * n + k : in.x1 + (long long)(c - m * m) * n + k;
  }
};

// Phase 1: each warp composes its chunk from the identity; the total
// [A | B] goes to tot.
template <typename S, int M>
__global__ void __launch_bounds__(kGenThreads)
aff_chunk_pass(long long n, long long chunk, long long nb, int teams, int team_bytes,
               int reverse, GIn<S> in, Acc* tot) {
  const WarpTeam tm;
  const long long b = ric_chunk_index<WarpTeam>(teams);
  if (b >= nb) return;
  const int m = M, mm = m * m, w = m + 1, t = tm.rank(), nt = tm.size();
  const AffTeam<S> r(ric_team_base<WarpTeam>(team_bytes), m);
  const long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  Acc* cur = r.V0;
  Acc* nxt = r.V1;
  for (int i = t; i < m * w; i += nt) cur[i] = i / w == i % w ? Acc(1) : Acc(0);
  tm.sync();
  team_walk(tm, mm + m, aff_stage_stride(m), r.ast, r.sst, n, reverse, lo, hi,
            AffSrc<S>{in, m, n},
            [&](int, const Acc* E) {
              // [A | B]' = A_l [A | B] + [0 | B_l]
              for (int e = t; e < m * w; e += nt) {
                const int i = e / w, j = e - i * w;
                Acc acc = Acc(0);
#pragma unroll
                for (int l = 0; l < m; ++l) acc += E[i * m + l] * cur[l * w + j];
                nxt[e] = j == m ? E[mm + i] + acc : acc;
              }
              tm.sync();
              Acc* swap = cur;
              cur = nxt;
              nxt = swap;
            },
            [](long long, int) {});
  Acc* dst = tot + b * (mm + m);
  for (int i = t; i < mm + m; i += nt)
    dst[i] = i < mm ? cur[(i / m) * w + i % m] : cur[(i - mm) * w + m];
}

// Phase 3: each warp steps the state from the prefix's leaf through its
// chunk, gathering a batch's states (before or after each element) and
// writing them once the batch is done.
template <typename S, typename O, int M>
__global__ void __launch_bounds__(kGenThreads)
aff_finish_pass(long long n, long long chunk, long long nb, int teams, int team_bytes,
                int reverse, int inclusive, GIn<S> in, O* out, const Acc* incl) {
  const WarpTeam tm;
  const long long b = ric_chunk_index<WarpTeam>(teams);
  if (b >= nb) return;
  const int m = M, mm = m * m, t = tm.rank(), nt = tm.size();
  const int os = aff_state_stride(m);
  const AffTeam<S> r(ric_team_base<WarpTeam>(team_bytes), m);
  const long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  Acc* g = r.V0;
  Acc* nw = r.V1;
  for (int i = t; i < m; i += nt) g[i] = b == 0 ? Acc(0) : incl[(b - 1) * (mm + m) + mm + i];
  tm.sync();
  team_walk(tm, mm + m, aff_stage_stride(m), r.ast, r.sst, n, reverse, lo, hi,
            AffSrc<S>{in, m, n},
            [&](int j, const Acc* E) {
              if (!inclusive)
                for (int i = t; i < m; i += nt) r.ost[j * os + i] = g[i];
              // A g + B
              for (int i = t; i < m; i += nt) {
                Acc acc = Acc(0);
#pragma unroll
                for (int l = 0; l < m; ++l) acc += E[i * m + l] * g[l];
                nw[i] = E[mm + i] + acc;
              }
              tm.sync();
              Acc* swap = g;
              g = nw;
              nw = swap;
              if (inclusive)
                for (int i = t; i < m; i += nt) r.ost[j * os + i] = g[i];
            },
            [&](long long base, int cnt) {
              for (int idx = t; idx < m * cnt; idx += nt) {
                const int i = idx / cnt, j = idx - i * cnt;
                out[(long long)i * n + g_element_index(base + j, n, reverse)] =
                    O(r.ost[j * os + i]);
              }
            });
}

// ------------------------------------------------------------------ kernels

// Phase 1 for the other monoids: each block composes its chunk with the
// full combine.
template <typename S>
__global__ void __launch_bounds__(kGenThreads)
g_chunk_pass(GSpec s, long long n, long long chunk, int reverse, GIn<S> in, Acc* tot) {
  Acc* sm = reinterpret_cast<Acc*>(qsl_smem);
  const int size = g_size(s, s.rc);
  Acc* acc = sm;
  Acc* x = sm + size;
  Acc* o = sm + 2 * size;
  Acc* scr = sm + 3 * size;
  int* piv = reinterpret_cast<int*>(scr + g_scratch(s));
  const int group = blockIdx.y, c = g_cols(s, group), col0 = group * s.rc;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  g_element(s, c, col0, n, in, g_element_index(lo, n, reverse), acc);
  for (long long pos = lo + 1; pos < hi; ++pos) {
    g_element(s, c, col0, n, in, g_element_index(pos, n, reverse), x);
    g_combine<0>(BlockTeam(), s, c, acc, x, o, scr, piv);
    Acc* swap = acc;
    acc = o;
    o = swap;
  }
  Acc* dst = tot + ((long long)group * gridDim.x + blockIdx.x) * size;
  for (int i = threadIdx.x; i < g_size(s, c); i += blockDim.x) dst[i] = acc[i];
}

// One Hillis-Steele step over the nb chunk totals of each column group:
// out[b] = in[b - off] . in[b], one team per total (team_elems values of
// shared memory each); M > 0 is the order as a compile-time constant.
template <class Team, int M>
__global__ void __launch_bounds__(kGenThreads)
g_totals_pass(GSpec s, long long off, long long nb, int teams, int team_elems, const Acc* in,
              Acc* out) {
  const Team tm;
  const long long b = Team::kWarp ? (long long)blockIdx.x * teams + threadIdx.x / 32
                                  : (long long)blockIdx.x;
  if (b >= nb) return;
  Acc* scr = reinterpret_cast<Acc*>(qsl_smem) + (Team::kWarp ? threadIdx.x / 32 : 0) * team_elems;
  int* piv = reinterpret_cast<int*>(scr + g_scratch(s));
  const int size = g_size(s, s.rc), c = g_cols(s, blockIdx.y);
  const long long at = ((long long)blockIdx.y * nb + b) * size;
  if (b < off) {
    for (int i = tm.rank(); i < g_size(s, c); i += tm.size()) out[at + i] = in[at + i];
    return;
  }
  g_combine<M>(tm, s, c, in + at - off * size, in + at, out + at, scr, piv);
}

// Phase 3 for the other monoids.
template <typename S, typename O>
__global__ void __launch_bounds__(kGenThreads)
g_finish_pass(GSpec s, long long n, long long chunk, int reverse, int inclusive,
              GIn<S> in, O* out, const Acc* incl) {
  Acc* sm = reinterpret_cast<Acc*>(qsl_smem);
  const int size = g_size(s, s.rc);
  Acc* g = sm;
  Acc* nw = sm + size;
  Acc* x = sm + 2 * size;
  Acc* t = sm + 3 * size;
  const int group = blockIdx.y, c = g_cols(s, group), col0 = group * s.rc;
  const int state = g_state_size(s, c);
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < state; i += blockDim.x) g[i] = Acc(0);
  } else {
    // The state at the chunk's start is the leaf of the inclusive total of
    // the chunks before it (every scan starts at 0).
    const Acc* src = incl + ((long long)group * gridDim.x + blockIdx.x - 1) * size + g_leaf(s);
    for (int i = threadIdx.x; i < state; i += blockDim.x) g[i] = src[i];
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  for (long long pos = lo; pos < hi; ++pos) {
    const long long k = g_element_index(pos, n, reverse);
    if (!inclusive) g_store(BlockTeam(), s, c, col0, n, out, k, g);
    g_step(s, c, col0, n, in, k, g, nw, x, t);
    Acc* swap = g;
    g = nw;
    nw = swap;
    if (inclusive) g_store(BlockTeam(), s, c, col0, n, out, k, g);
  }
}

// ---------------------------------------------------------------- host side

// Launch k on the stream with its parameters converted to its own types,
// through cudaLaunchKernel, so that one helper serves every kernel; above
// the default 48 KB of dynamic shared memory it raises the kernel's limit.
template <typename T>
struct g_same {
  using type = T;
};

template <typename... P>
cudaError_t g_launch(void (*k)(P...), dim3 grid, int threads, long long smem,
                     cudaStream_t st, typename g_same<P>::type... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  void* argv[] = {static_cast<void*>(&args)...};
  return cudaLaunchKernel(k, grid, dim3(threads), argv, (size_t)smem, st);
}

// The scan's monoid and shape; rc keeps a block's products near one output
// entry per thread.
inline GSpec g_spec(int kind, int m, int m2, int r) {
  GSpec s{kind, m, kind == gCpl ? m2 : m, kind == gAff ? r : 1, 1};
  if (kind == gAff) {
    int rc = kGenThreads / m;
    if (rc < m) rc = m;
    s.rc = rc < r ? rc : r;
  }
  return s;
}

// The Riccati step's element (a, p, q, d) must fit a value's 3 m^2 slots.
inline bool g_valid(int kind, int m, int m2, long long n, int r) {
  return kind >= gAff && kind <= gCpl && m >= 1 && m <= kGenMaxM && m2 >= 1 &&
         m2 <= kGenMaxM && n >= 1 && r >= 1 && r <= 65535 &&
         (kind == gAff || r == 1) && (kind == gCpl || m2 == m) &&
         (kind != gRic || m >= 2);
}

struct GPlan {
  bool warp;       // one warp per chunk (the Riccati flow at small orders)
  int threads, groups, size, teams;
  int team_elems;  // a Riccati team's shared values, in Acc (ric_team_bytes)
  long long smem, chunk, nb, blocks;
};

inline int g_sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

inline long long g_chunks_of(long long n, long long target, long long min_chunk, GPlan& p) {
  if (target < 1) target = 1;
  p.chunk = (n + target - 1) / target;
  if (p.chunk < min_chunk) p.chunk = min_chunk;
  return (n + p.chunk - 1) / p.chunk;
}

// Threads, shared memory and chunks. The Riccati flow and the affine scan
// with one column: at m <= kWarpTeamMaxM a warp per chunk, kWarpTeams to a
// block, about kRicWarpTeamsPerSM chunks per multiprocessor (fewer chunks
// mean fewer totals launches; each warp then walks a longer chunk); above,
// for the Riccati flow, a block of about m^2 threads per chunk. The rest: a
// block per chunk,
// enough chunks for one wave of blocks on every multiprocessor, each
// chunk at least kGenMinChunk elements.
inline GPlan g_plan(const GSpec& s, long long n) {
  GPlan p;
  p.groups = (s.r + s.rc - 1) / s.rc;
  p.size = g_size(s, s.rc);
  p.teams = 1;
  p.team_elems = 0;
  const int m = s.m, m2 = s.m2;
  const bool warp_aff = s.kind == gAff && s.r == 1 && m <= kWarpTeamMaxM;
  if (s.kind == gRic || warp_aff) {
    p.warp = warp_aff || m <= kWarpTeamMaxM;
    p.team_elems =
        (int)((warp_aff ? aff_team_bytes(m) : ric_team_bytes(m, p.warp)) / sizeof(Acc));
    if (p.warp) {
      p.teams = kWarpTeams;
      p.threads = 32 * kWarpTeams;
      p.smem = (long long)p.teams * p.team_elems * sizeof(Acc) + 16;
      long long blocks = kGenSharedSM / (p.smem + 1024);
      if (blocks > 2048 / p.threads) blocks = 2048 / p.threads;
      long long teams = blocks * p.teams;
      if (teams > kRicWarpTeamsPerSM) teams = kRicWarpTeamsPerSM;
      if (teams < 1) teams = 1;
      p.nb = g_chunks_of(n, g_sm_count() * teams, kRicMinChunk, p);
      p.blocks = (p.nb + p.teams - 1) / p.teams;
      return p;
    }
    const int threads = (m * m + 31) / 32 * 32;
    p.threads = threads > kGenThreads ? kGenThreads : threads;
    p.smem = (long long)p.team_elems * sizeof(Acc) + 16;
  } else {
    p.warp = false;
    int work = m * m;
    if (s.kind == gAff && m * s.rc > work) work = m * s.rc;
    if (s.kind == gCpl) {
      if (m2 * m2 > work) work = m2 * m2;
      if (m * m2 > work) work = m * m2;
    }
    const int threads = (work + 31) / 32 * 32;
    p.threads = threads > kGenThreads ? kGenThreads : threads;
    p.smem = (3LL * p.size + g_scratch(s)) * (long long)sizeof(Acc) + 16;
  }
  long long per_sm = 2048 / p.threads;
  if (per_sm > 32) per_sm = 32;
  const long long by_smem = kGenSharedSM / (p.smem + 1024);
  if (by_smem < per_sm) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  p.nb = g_chunks_of(n, g_sm_count() * per_sm / p.groups, kGenMinChunk, p);
  p.blocks = p.nb;
  return p;
}

// Workspace of one scan, in Acc: two buffers of chunk totals.
inline long long g_workspace_elems(const GSpec& s, long long n) {
  const GPlan p = g_plan(s, n);
  return 2LL * p.groups * p.nb * p.size;
}

// The Riccati flow's three phases with teams of type Team, at the order M
// (0: the order s.m at run time).
template <class Team, int M, typename S, typename O>
cudaError_t ric_run(const GSpec& s, const GPlan& p, long long n, int reverse, int inclusive,
                    const GIn<S>& in, O* out, Acc* work, cudaStream_t st, const RicEmit<S>& em) {
  Acc* cur = work;
  Acc* other = work + p.nb * p.size;
  const dim3 grid((unsigned)p.blocks);
  const int team_bytes = p.team_elems * (int)sizeof(Acc);
  cudaError_t e = g_launch(ric_chunk_pass<S, Team, M>, grid, p.threads, p.smem, st, s, n,
                           p.chunk, p.nb, p.teams, team_bytes, reverse, in, cur);
  for (long long off = 1; e == cudaSuccess && off < p.nb; off <<= 1) {
    e = g_launch(g_totals_pass<Team, M>, grid, p.threads, p.smem, st, s, off, p.nb, p.teams,
                 p.team_elems, (const Acc*)cur, other);
    Acc* swap = cur;
    cur = other;
    other = swap;
  }
  if (e != cudaSuccess) return e;
  return g_launch(ric_finish_pass<S, O, Team, M>, grid, p.threads, p.smem, st, s, n,
                  p.chunk, p.nb, p.teams, team_bytes, reverse, inclusive, in, out,
                  (const Acc*)cur, em);
}

// The affine scan's three phases with one column, a warp per chunk, at the
// order M.
template <int M, typename S, typename O>
cudaError_t aff_run(const GSpec& s, const GPlan& p, long long n, int reverse, int inclusive,
                    const GIn<S>& in, O* out, Acc* work, cudaStream_t st) {
  Acc* cur = work;
  Acc* other = work + p.nb * p.size;
  const dim3 grid((unsigned)p.blocks);
  const int team_bytes = p.team_elems * (int)sizeof(Acc);
  cudaError_t e = g_launch(aff_chunk_pass<S, M>, grid, p.threads, p.smem, st, n, p.chunk, p.nb,
                           p.teams, team_bytes, reverse, in, cur);
  for (long long off = 1; e == cudaSuccess && off < p.nb; off <<= 1) {
    e = g_launch(g_totals_pass<WarpTeam, M>, grid, p.threads, p.smem, st, s, off, p.nb,
                 p.teams, p.team_elems, (const Acc*)cur, other);
    Acc* swap = cur;
    cur = other;
    other = swap;
  }
  if (e != cudaSuccess) return e;
  return g_launch(aff_finish_pass<S, O, M>, grid, p.threads, p.smem, st, n, p.chunk, p.nb,
                  p.teams, team_bytes, reverse, inclusive, in, out, (const Acc*)cur);
}

// One scan into out (the state before or after each element), on stream st,
// with a workspace of g_workspace_elems(s, n) values. For the Riccati flow,
// an emission em with em.A set writes B1's emission (RicEmit, exclusive)
// in place of the states, and out is not written. The warp-team paths
// (the Riccati flow, and the affine scan with one column, at m <=
// kWarpTeamMaxM) take the orders above the templated sources', 5..8.
template <typename S, typename O>
cudaError_t g_run(const GSpec& s, long long n, int reverse, int inclusive,
                  const GIn<S>& in, O* out, Acc* work, cudaStream_t st,
                  const RicEmit<S>& em = RicEmit<S>{}) {
  const GPlan p = g_plan(s, n);
  if (p.smem > kGenSharedBlock || p.nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (s.kind == gAff && p.warp) {
    switch (s.m) {
      case 5: return aff_run<5>(s, p, n, reverse, inclusive, in, out, work, st);
      case 6: return aff_run<6>(s, p, n, reverse, inclusive, in, out, work, st);
      case 7: return aff_run<7>(s, p, n, reverse, inclusive, in, out, work, st);
      case 8: return aff_run<8>(s, p, n, reverse, inclusive, in, out, work, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (s.kind == gRic) {
#define RIC_RUN(Team, M) \
  return ric_run<Team, M>(s, p, n, reverse, inclusive, in, out, work, st, em)
    // The orders of the models on the paths (m = 5 sums, posteriors of
    // order 8, 12 and 16) with the order a compile-time constant.
    if (p.warp) {
      switch (s.m) {
        case 5: RIC_RUN(WarpTeam, 5);
        case 6: RIC_RUN(WarpTeam, 6);
        case 7: RIC_RUN(WarpTeam, 7);
        case 8: RIC_RUN(WarpTeam, 8);
        default: return cudaErrorInvalidValue;
      }
    }
    switch (s.m) {
      case 12: RIC_RUN(BlockTeam, 12);
      case 16: RIC_RUN(BlockTeam, 16);
      default: RIC_RUN(BlockTeam, 0);
    }
#undef RIC_RUN
  }
  Acc* cur = work;
  Acc* other = work + (long long)p.groups * p.nb * p.size;
  const dim3 grid((unsigned)p.nb, (unsigned)p.groups);
  const long long totals_smem = g_scratch(s) * (long long)sizeof(Acc) + 16;
  cudaError_t e = g_launch(g_chunk_pass<S>, grid, p.threads, p.smem, st, s, n,
                           p.chunk, reverse, in, cur);
  for (long long off = 1; e == cudaSuccess && off < p.nb; off <<= 1) {
    e = g_launch(g_totals_pass<BlockTeam, 0>, grid, p.threads, totals_smem, st, s, off, p.nb, 1, 0,
                 (const Acc*)cur, other);
    Acc* swap = cur;
    cur = other;
    other = swap;
  }
  if (e != cudaSuccess) return e;
  return g_launch(g_finish_pass<S, O>, grid, p.threads, p.smem, st, s, n,
                  p.chunk, reverse, inclusive, in, out, (const Acc*)cur);
}

}  // namespace
