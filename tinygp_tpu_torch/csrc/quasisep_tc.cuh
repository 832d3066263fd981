// The float64 tensor-core pieces of the one-launch generic-order scans on
// Hopper (sm_90a), shared by kernel B3 (quasisep_generic.cu up to order 16:
// ric_tile_kernel, aff_tile_kernel, cong_tile_kernel, cpl_tc_tile_kernel;
// quasisep_wide.cu above: the *_wide_kernel) and kernel B2 above m = 8
// (quasisep_loglik_generic.cu: b2_tc_kernel): a warp's matrices in the
// layout of mma.sync.m16n8k8.f64's accumulator (Frag) and their products
// (xzt, smm), the affine, congruence, coupling and Riccati monoids as the
// skeletons' Ops (AffOp, CongOp, CplOp, RicOp), the pivoted Gauss-Jordan
// elimination of the Riccati merges (warp_gj, block_gj), and the one-warp
// skeleton's grouped look-back (mono_lookback).
//
// An Op holds a warp team's running map in registers (Run), an element
// (El), the walk's state (State) and, for maps in shared memory, the merge
// of an earlier map with a later one and a map's application to a state,
// both on the tensor cores by one warp or, above order 16, by a block (its
// MM). Orders up to P are padded with zeros, which every product keeps.

#pragma once

#include "quasisep_generic.cuh"

namespace {

constexpr int kMonoTeams = 4;                       // warp teams a tile
constexpr int kMonoRun = 4;                         // look-back aggregates a warp folds
constexpr int kMonoGroup = kMonoTeams * kMonoRun;   // tiles a look-back group

// A warp's share of an R x C matrix (R and C multiples of 8) in the layout
// of the mma's accumulator: lane (g, t) = (lane / 4, lane % 4) holds entry
// (8 h + g, 8 k + 2 t + j) as v[k][h][j].
template <int R, int C>
struct Frag {
  Acc v[C / 8][R / 8][2];
};

__device__ __forceinline__ void mma884(Acc (&c)[4], Acc a0, Acc a1, Acc a2, Acc a3, Acc b0,
                                       Acc b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// D = X Z^T for X (R x K) and Z (N x K), all Frags; D aliases neither. A
// 16-row tile of the mma takes two row halves of X (the second zero past
// R).
template <int R, int K, int N>
__device__ __forceinline__ void xzt(const Frag<R, K>& X, const Frag<N, K>& Z, Frag<R, N>& D) {
  constexpr int H = R / 8;
#pragma unroll
  for (int mt = 0; mt < (H + 1) / 2; ++mt) {
    constexpr int kLast = H - 1;
    const int h0 = 2 * mt, h1 = 2 * mt + 1 < H ? 2 * mt + 1 : kLast;
    const bool hi = 2 * mt + 1 < H;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      Acc c[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
#pragma unroll
      for (int kt = 0; kt < K / 8; ++kt)
        mma884(c, X.v[kt][h0][0], hi ? X.v[kt][h1][0] : Acc(0), X.v[kt][h0][1],
               hi ? X.v[kt][h1][1] : Acc(0), Z.v[kt][nt][0], Z.v[kt][nt][1]);
      D.v[nt][h0][0] = c[0];
      D.v[nt][h0][1] = c[1];
      if (hi) {
        D.v[nt][h1][0] = c[2];
        D.v[nt][h1][1] = c[3];
      }
    }
  }
}

// y = X v for X (R x C) and v given at the lane's columns (vc[k][j] =
// v[8 k + 2 t + j]); y at the lane's rows (y[h] = y_{8 h + g}), the same
// on the four lanes of a quad.
template <int R, int C>
__device__ __forceinline__ void rowdot(const Frag<R, C>& X, const Acc (&vc)[C / 8][2],
                                       Acc (&y)[R / 8]) {
#pragma unroll
  for (int h = 0; h < R / 8; ++h) {
    Acc acc = Acc(0);
#pragma unroll
    for (int k = 0; k < C / 8; ++k) acc += X.v[k][h][0] * vc[k][0] + X.v[k][h][1] * vc[k][1];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    y[h] = acc;
  }
}

// A vector at the lane's rows (vr[h] = v_{8 h + g}) to its columns.
template <int C>
__device__ __forceinline__ void to_cols(const Acc (&vr)[C / 8], Acc (&vc)[C / 8][2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < C / 8; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j) vc[k][j] = __shfl_sync(0xffffffffu, vr[k], 4 * (2 * t + j));
}

// sum_r x_r y_r of two vectors at the lane's rows, the same on every lane
// (butterflies over the quads, whose lanes hold equal values).
template <int P>
__device__ __forceinline__ Acc row_sum(const Acc (&x)[P / 8], const Acc (&y)[P / 8]) {
  Acc acc = Acc(0);
#pragma unroll
  for (int h = 0; h < P / 8; ++h) acc += x[h] * y[h];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Loads through a pointer into shared memory, or through L2 (ld.cg) from a
// map another block published.
struct SmemRd {
  const Acc* p;
  __device__ Acc operator[](int i) const { return p[i]; }
  __device__ SmemRd at(int off) const { return SmemRd{p + off}; }
};
struct L2Rd {
  const Acc* p;
  __device__ Acc operator[](int i) const { return __ldcg(p + i); }
  __device__ L2Rd at(int off) const { return L2Rd{p + off}; }
};

// By one warp: D (R x N) = X Y [+ E] [+ I] on the tensor cores, with X
// (R x K) read at X[r * xr + k * xk], Y (K x N) at Y[k * yk + n * yn], E
// (columns e0 and on) at E[r * le + n - e0] and D at D[r * ld + n]. Every
// operand is read before any entry is written, so D may alias X, Y or E.
// Ends with the warp's barrier.
template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
__device__ __forceinline__ void smm(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld,
                                    const ER* E = nullptr, int le = 0, bool eye = false,
                                    int e0 = 0) {
  constexpr int MT = (R + 15) / 16, NT = N / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Acc c[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mt][nt][i] = Acc(0);
#pragma unroll
  for (int kt = 0; kt < K / 8; ++kt) {
    Acc b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) b[nt][i] = Y[(8 * kt + t + 4 * i) * yk + (8 * nt + g) * yn];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      Acc a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i & 1);
        a[i] = r < R ? X[r * xr + (8 * kt + t + 4 * (i >> 1)) * xk] : Acc(0);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma884(c[mt][nt], a[0], a[1], a[2], a[3], b[nt][0], b[nt][1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i >> 1), col = 8 * nt + 2 * t + (i & 1);
        if (r < R) {
          Acc v = c[mt][nt][i];
          if (E && col >= e0) v += (*E)[r * le + col - e0];
          if (eye && r == col) v += Acc(1);
          D[r * ld + col] = v;
        }
      }
  __syncwarp();
}

// Error-free transformations (Ogita, Rump and Oishi, "Accurate sum and dot
// product", SIAM J. Sci. Comput. 26, 2005), written with the _rn
// intrinsics so that the compiler fuses nothing into a multiply-add.
__device__ __forceinline__ void two_sum(Acc a, Acc b, Acc& s, Acc& e) {
  s = __dadd_rn(a, b);
  const Acc z = __dsub_rn(s, a);
  e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, z)), __dsub_rn(b, z));
}

// By one warp: smm's D (R x N) = X Y [+ E] over the first k of X's K
// columns and Y's K rows, each entry a compensated dot product (Dot2: as
// if in twice the working precision, rounded once) on the CUDA cores, in
// smm's layout of entries over the lanes. For products whose terms cancel
// by orders of magnitude (the congruence's maps over long spans); the
// terms past k must be zero in the entries the caller reads. Every operand
// is read before any entry is written. Ends with the warp's barrier.
template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
__device__ __forceinline__ void smm2(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld,
                                     int k, const ER* E = nullptr, int le = 0) {
  constexpr int MT = (R + 15) / 16, NT = N / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Acc s[MT][NT][4], c[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[mt][nt][i] = c[mt][nt][i] = Acc(0);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    if (kk >= k) break;
    Acc x[MT][2], y[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        x[mt][h] = r < R ? X[r * xr + kk * xk] : Acc(0);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) y[nt][j] = Y[kk * yk + (8 * nt + 2 * t + j) * yn];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Acc a = x[mt][i >> 1], b = y[nt][i & 1];
          const Acc p = __dmul_rn(a, b), q = __fma_rn(a, b, -p);
          Acc e;
          two_sum(s[mt][nt][i], p, s[mt][nt][i], e);
          c[mt][nt][i] = __dadd_rn(c[mt][nt][i], __dadd_rn(e, q));
        }
  }
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i >> 1), col = 8 * nt + 2 * t + (i & 1);
        if (r < R) {
          Acc v = s[mt][nt][i], w = c[mt][nt][i];
          if (E) {
            Acc e;
            two_sum(v, (*E)[r * le + col], v, e);
            w = __dadd_rn(w, e);
          }
          D[r * ld + col] = __dadd_rn(v, w);
        }
      }
  __syncwarp();
}

// 16-byte alignment, shared-memory addresses and 16-byte cp.async, for the
// one-launch scans' staging (quasisep_generic.cu, quasisep_wide.cu).
template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes (both addresses 16-byte aligned) from device to shared
// memory asynchronously, through L2 only.
template <typename S>
__device__ __forceinline__ void cp_async16(S* dst, const S* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Who runs an Op's merges and applications of maps in shared memory: one
// warp (WarpMM: the one-launch skeleton's teams and B2's), or a whole block
// (quasisep_generic.cu: BlockMM, the teams of the scans at m = 17..32).
// Its threads, a thread's index among them, their barrier, and the
// products smm and smm2 by those threads.
struct WarpMM {
  static constexpr int kThreads = 32;
  __device__ static int tid() { return threadIdx.x & 31; }
  __device__ static void sync() { __syncwarp(); }
  template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
  __device__ static void mm(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld,
                            const ER* E = nullptr, int le = 0, bool eye = false, int e0 = 0) {
    smm<R, N, K>(X, xr, xk, Y, yk, yn, D, ld, E, le, eye, e0);
  }
  template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
  __device__ static void mm2(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld, int k,
                             const ER* E = nullptr, int le = 0) {
    smm2<R, N, K>(X, xr, xk, Y, yk, yn, D, ld, k, E, le);
  }
};

// By warp 0: publish `size` values of src at dst, then set *flag to v.
__device__ __forceinline__ void publish_values(const Acc* src, Acc* dst, int size, unsigned* flag,
                                            unsigned v) {
  for (int c = threadIdx.x; c < size; c += 32) dst[c] = src[c];
  __threadfence();
  __syncwarp();
  if (threadIdx.x == 0) st_release(flag, v);
}

// The affine scan at padded order P with RC columns a group: a map is
// P x (P + RC), [A | B], row stride LM; a state P x RC, stride LS. MM runs
// its products of maps in shared memory (WarpMM above).
template <int P, int RC, class MM = WarpMM>
struct AffOp {
  static constexpr int H = P / 8, HX = (P + RC) / 8, HS = RC / 8;
  static constexpr int LM = P + RC + 4, LS = RC + 4;
  static constexpr int kMap = P * LM, kState = P * LS, kScratch = 0;
  static constexpr int kKind = gAff, kMaxComps = P * P + P * RC;

  // A team's running value [A^T; B^T] ((P + RC) x P).
  struct Run {
    Frag<P + RC, P> X;
  };
  // An element: a, and b^T at the lanes' entries of rows P.. of Run::X.
  struct El {
    Frag<P, P> a;
    Frag<RC, P> bt;
  };

  int m, cols;  // the order and this group's columns (<= RC)
  __device__ static int comps(int m, int cols) { return m * m + m * cols; }

  template <typename S>
  __device__ __forceinline__ void load(const S* st, int LD, int i, El& e) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          e.a.v[k][h][jj] = r < m && c < m ? Acc(st[(r * m + c) * LD + i]) : Acc(0);
        }
#pragma unroll
      for (int h = 0; h < HS; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * h + g, r = 8 * k + 2 * t + jj;
          e.bt.v[k][h][jj] =
              col < cols && r < m ? Acc(st[(m * m + r * cols + col) * LD + i]) : Acc(0);
        }
    }
  }

  __device__ static void identity(Run& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < HX; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.X.v[k][h][jj] = 8 * h + g == 8 * k + 2 * t + jj ? Acc(1) : Acc(0);
  }

  __device__ static void fold(Run& x, const El& e) {
    Frag<P + RC, P> T;
    xzt(x.X, e.a, T);
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.X.v[k][h][jj] = T.v[k][h][jj];
#pragma unroll
      for (int h = 0; h < HS; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.X.v[k][H + h][jj] = T.v[k][H + h][jj] + e.bt.v[k][h][jj];
    }
  }

  // [A | B] = X^T into map.
  __device__ static void store(const Run& x, Acc* map) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < HX; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) map[(8 * k + 2 * t + jj) * LM + 8 * h + g] = x.X.v[k][h][jj];
    __syncwarp();
  }

  // The walk's state s^T (RC x P).
  struct State {
    Frag<RC, P> s;
  };
  __device__ static void load_state(const Acc* s, State& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < HS; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.s.v[k][h][jj] = s[(8 * k + 2 * t + jj) * LS + 8 * h + g];
  }
  __device__ static void walk(State& x, const El& e) {
    Frag<RC, P> T;
    xzt(x.s, e.a, T);
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < HS; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.s.v[k][h][jj] = T.v[k][h][jj] + e.bt.v[k][h][jj];
  }
  // The state as element i's output, over its staged b (the lane's own).
  template <typename S>
  __device__ __forceinline__ void put(const State& x, S* st, int LD, int i) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < HS; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * h + g, r = 8 * k + 2 * t + jj;
          if (col < cols && r < m) st[(m * m + r * cols + col) * LD + i] = S(x.s.v[k][h][jj]);
        }
  }
  __device__ int out_comp(int q) const { return m * m + q; }
  __device__ int out_rows() const { return m * cols; }
  // Where staged component c sits in a map (an element as a map) and output
  // row q in a state (quasisep_generic.cu: wide_tile).
  __device__ int el_slot(int c) const {
    const int q = c - m * m;
    return c < m * m ? c / m * LM + c % m : q / cols * LM + P + q % cols;
  }
  __device__ int state_slot(int q) const { return q / cols * LS + q % cols; }

  __device__ static void identity_map(Acc* map) {
    for (int p = MM::tid(); p < kMap; p += MM::kThreads) {
      const int r = p / LM, c = p % LM;
      map[p] = c == r ? Acc(1) : Acc(0);
    }
    MM::sync();
  }
  // out = (A_l A_e, A_l B_e + B_l); out aliases neither.
  template <class LR>
  __device__ void merge(const Acc* e, LR l, Acc* out, Acc*) const {
    const LR Bl = l.at(P);
    MM::template mm<P, P + RC, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM, &Bl, LM, false, P);
  }
  // out = A s + B; out may alias s.
  __device__ void apply(const Acc* map, const Acc* s, Acc* out, Acc*) const {
    const SmemRd Bm{map + P};
    MM::template mm<P, RC, P>(SmemRd{map}, LM, 1, SmemRd{s}, LS, 1, out, LS, &Bm, LM);
  }
  // The look-back's merge of runs of tiles (mono_lookback): the same.
  template <class LR>
  __device__ void merge_lb(const Acc* e, LR l, Acc* out, Acc* Wb) const { merge(e, l, out, Wb); }
};

// The congruence scan g' = A g A^T + B at padded order P. A map in shared
// memory is P x 2P, [A | B], row stride LM; a state P x P, stride LS. The
// running value keeps A^T, as RicOp does, so that its update is the
// product A^T a^T; B's is a (a B^T)^T, two products with the element's a
// as the X operand. Neither B nor the state is taken to be symmetric.
//
// kDot2: the look-back's merges of runs of tiles (spans of hundreds of
// elements) take compensated products (merge_lb: smm2). Where the
// transitions have an eigenvalue near 1 and are far from normal (the
// posterior processes' Riccati adjoint, B3), a map's A grows with its
// span, and A_l B_e A_l^T sums terms orders of magnitude above the result:
// with plain float64 sums the look-back lost several times the digits of
// the sequential recurrence; compensating its applications to states as
// well gained little more (PERF.md §6). B2's adjoint (the likelihood's
// whitening transitions) keeps the tensor cores there. The element folds,
// the in-tile scan, the applications and the walk keep the tensor cores.
template <int P, bool kDot2, class MM = WarpMM>
struct CongOp {
  static constexpr int H = P / 8, LM = 2 * P + 4, LS = P + 4;
  static constexpr int kMap = P * LM, kState = P * LS, kScratch = P * LS;
  static constexpr int kKind = gCong, kMaxComps = 2 * P * P;

  // A team's running value: A^T, B.
  struct Run {
    Frag<P, P> At, B;
  };
  // An element: its a and b.
  struct El {
    Frag<P, P> a, b;
  };

  int m, cols;  // the order; cols is unused (one chain)
  __device__ static int comps(int m, int) { return 2 * m * m; }

  template <typename S>
  __device__ __forceinline__ void load(const S* st, int LD, int i, El& e) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          const bool in = r < m && c < m;
          e.a.v[k][h][jj] = in ? Acc(st[(r * m + c) * LD + i]) : Acc(0);
          e.b.v[k][h][jj] = in ? Acc(st[(m * m + r * m + c) * LD + i]) : Acc(0);
        }
  }

  __device__ static void identity(Run& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          x.At.v[k][h][jj] = 8 * h + g == 8 * k + 2 * t + jj ? Acc(1) : Acc(0);
          x.B.v[k][h][jj] = Acc(0);
        }
  }

  // g <- a g a^T + b.
  __device__ static void step(Frag<P, P>& g, const El& e) {
    Frag<P, P> T;
    xzt(e.a, g, T);  // a g^T
    xzt(e.a, T, g);  // a g a^T
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) g.v[k][h][jj] += e.b.v[k][h][jj];
  }

  // The element folded after the running value: A' = a A, B' = a B a^T + b.
  __device__ static void fold(Run& x, const El& e) {
    Frag<P, P> T;
    xzt(x.At, e.a, T);  // A^T a^T
    x.At = T;
    step(x.B, e);
  }

  // [A | B] into map.
  __device__ static void store(const Run& x, Acc* map) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          map[c * LM + r] = x.At.v[k][h][jj];
          map[r * LM + P + c] = x.B.v[k][h][jj];
        }
    __syncwarp();
  }

  // The walk's state g.
  struct State {
    Frag<P, P> g;
  };
  __device__ static void load_state(const Acc* s, State& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.g.v[k][h][jj] = s[(8 * h + g) * LS + 8 * k + 2 * t + jj];
  }
  __device__ static void walk(State& x, const El& e) { step(x.g, e); }
  // The state as element i's output, over its staged b (the lane's own
  // entries of b, which it has read).
  template <typename S>
  __device__ __forceinline__ void put(const State& x, S* st, int LD, int i) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          if (r < m && c < m) st[(m * m + r * m + c) * LD + i] = S(x.g.v[k][h][jj]);
        }
  }
  __device__ int out_comp(int q) const { return m * m + q; }
  __device__ int out_rows() const { return m * m; }
  __device__ int el_slot(int c) const {
    const int q = c - m * m;
    return c < m * m ? c / m * LM + c % m : q / m * LM + P + q % m;
  }
  __device__ int state_slot(int q) const { return q / m * LS + q % m; }

  __device__ static void identity_map(Acc* map) {
    for (int p = MM::tid(); p < kMap; p += MM::kThreads) {
      const int r = p / LM, c = p % LM;
      map[p] = c == r ? Acc(1) : Acc(0);
    }
    MM::sync();
  }
  // out = (A_l A_e, (A_l B_e) A_l^T + B_l) of the earlier map e and the
  // later l: three products; out aliases neither.
  template <class LR>
  __device__ void merge(const Acc* e, LR l, Acc* out, Acc*) const {
    MM::template mm<P, 2 * P, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM);  // A_l [A_e | B_e]
    const LR Bl = l.at(P);
    MM::template mm<P, P, P>(SmemRd{out + P}, LM, 1, l, 1, LM, out + P, LM, &Bl, LM);
  }
  // out = (A X) A^T + B; out may alias X, not map; Wb: kScratch values.
  __device__ void apply(const Acc* map, const Acc* X, Acc* out, Acc* Wb) const {
    const SmemRd mp{map};
    MM::template mm<P, P, P>(mp, LM, 1, SmemRd{X}, LS, 1, Wb, LS);
    const SmemRd Bm = mp.at(P);
    MM::template mm<P, P, P>(SmemRd{Wb}, LS, 1, mp, 1, LM, out, LS, &Bm, LM);
  }
  // The look-back's merge of runs: with kDot2 the same products
  // compensated, over the order's m terms (the padding's are zero). Both
  // products need it: A_l B_e's rounding is multiplied by A_l again.
  template <class LR>
  __device__ void merge_lb(const Acc* e, LR l, Acc* out, Acc* Wb) const {
    if constexpr (kDot2) {
      MM::template mm2<P, 2 * P, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM, m);
      const LR Bl = l.at(P);
      MM::template mm2<P, P, P>(SmemRd{out + P}, LM, 1, l, 1, LM, out + P, LM, m, &Bl, LM);
    } else {
      merge(e, l, out, Wb);
    }
  }
};

// The coupling g' = A g B^T + C at padded order P, both orders (m for A,
// m2 for B) padded to it. A map in shared memory is P x 3P, [A | B | C],
// row stride LM; a state (m x m2 padded) P x P, stride LS. The running
// value keeps A^T and B^T, so that their updates are the products
// A^T a^T and B^T b^T; C's is a (b C^T)^T + c, two products with the
// element's b and then a as the X operand: four products an element. A
// merge (A_l A_e, B_l B_e, (A_l C_e) B_l^T + C_l) is four too, and with
// kDot2 the look-back's merges of runs sum them compensated, as CongOp's:
// A_l C_e B_l^T is the congruence's product with a right factor of its own.
template <int P, bool kDot2, class MM = WarpMM>
struct CplOp {
  static constexpr int H = P / 8, LM = 3 * P + 4, LS = P + 4;
  static constexpr int kMap = P * LM, kState = P * LS, kScratch = P * LS;
  static constexpr int kKind = gCpl, kMaxComps = 3 * P * P;

  // A team's running value: A^T, B^T, C.
  struct Run {
    Frag<P, P> At, Bt, C;
  };
  // An element: its a, b and c.
  struct El {
    Frag<P, P> a, b, c;
  };

  int m, cols;  // the orders: cols is the second order, m2
  __device__ static int comps(int m, int m2) { return m * m + m2 * m2 + m * m2; }

  template <typename S>
  __device__ __forceinline__ void load(const S* st, int LD, int i, El& e) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, m2 = cols;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          e.a.v[k][h][jj] = r < m && c < m ? Acc(st[(r * m + c) * LD + i]) : Acc(0);
          e.b.v[k][h][jj] = r < m2 && c < m2 ? Acc(st[(m * m + r * m2 + c) * LD + i]) : Acc(0);
          e.c.v[k][h][jj] =
              r < m && c < m2 ? Acc(st[(m * m + m2 * m2 + r * m2 + c) * LD + i]) : Acc(0);
        }
  }

  __device__ static void identity(Run& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          x.At.v[k][h][jj] = x.Bt.v[k][h][jj] = 8 * h + g == 8 * k + 2 * t + jj ? Acc(1) : Acc(0);
          x.C.v[k][h][jj] = Acc(0);
        }
  }

  // g <- a g b^T + c.
  __device__ static void step(Frag<P, P>& g, const El& e) {
    Frag<P, P> T;
    xzt(e.b, g, T);  // b g^T
    xzt(e.a, T, g);  // a g b^T
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) g.v[k][h][jj] += e.c.v[k][h][jj];
  }

  // The element folded after the running value: A' = a A, B' = b B,
  // C' = a C b^T + c.
  __device__ static void fold(Run& x, const El& e) {
    Frag<P, P> T;
    xzt(x.At, e.a, T);  // A^T a^T
    x.At = T;
    xzt(x.Bt, e.b, T);  // B^T b^T
    x.Bt = T;
    step(x.C, e);
  }

  // [A | B | C] into map.
  __device__ static void store(const Run& x, Acc* map) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          map[c * LM + r] = x.At.v[k][h][jj];
          map[c * LM + P + r] = x.Bt.v[k][h][jj];
          map[r * LM + 2 * P + c] = x.C.v[k][h][jj];
        }
    __syncwarp();
  }

  // The walk's state g.
  struct State {
    Frag<P, P> g;
  };
  __device__ static void load_state(const Acc* s, State& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.g.v[k][h][jj] = s[(8 * h + g) * LS + 8 * k + 2 * t + jj];
  }
  __device__ static void walk(State& x, const El& e) { step(x.g, e); }
  // The state as element i's output, over its staged c (the lane's own
  // entries of c, which it has read).
  template <typename S>
  __device__ __forceinline__ void put(const State& x, S* st, int LD, int i) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, m2 = cols;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          if (r < m && c < m2) st[(m * m + m2 * m2 + r * m2 + c) * LD + i] = S(x.g.v[k][h][jj]);
        }
  }
  __device__ int out_comp(int q) const { return m * m + cols * cols + q; }
  __device__ int out_rows() const { return m * cols; }
  __device__ int el_slot(int c) const {
    const int m2 = cols, ob = m * m, oc = ob + m2 * m2;
    return c < ob   ? c / m * LM + c % m
           : c < oc ? (c - ob) / m2 * LM + P + (c - ob) % m2
                    : (c - oc) / m2 * LM + 2 * P + (c - oc) % m2;
  }
  __device__ int state_slot(int q) const { return q / cols * LS + q % cols; }

  __device__ static void identity_map(Acc* map) {
    for (int p = MM::tid(); p < kMap; p += MM::kThreads) {
      const int r = p / LM, c = p % LM;
      map[p] = c == r || c == r + P ? Acc(1) : Acc(0);
    }
    MM::sync();
  }
  // out = (A_l A_e, B_l B_e, (A_l C_e) B_l^T + C_l) of the earlier map e
  // and the later l; out aliases neither; Wb: kScratch values.
  template <class LR>
  __device__ void merge(const Acc* e, LR l, Acc* out, Acc* Wb) const {
    const LR Bl = l.at(P), Cl = l.at(2 * P);
    MM::template mm<P, P, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM);             // A_l A_e
    MM::template mm<P, P, P>(Bl, LM, 1, SmemRd{e + P}, LM, 1, out + P, LM);    // B_l B_e
    MM::template mm<P, P, P>(l, LM, 1, SmemRd{e + 2 * P}, LM, 1, Wb, LS);      // A_l C_e
    MM::template mm<P, P, P>(SmemRd{Wb}, LS, 1, Bl, 1, LM, out + 2 * P, LM, &Cl, LM);
  }
  // out = (A X) B^T + C; out may alias X, not map; Wb: kScratch values.
  __device__ void apply(const Acc* map, const Acc* X, Acc* out, Acc* Wb) const {
    const SmemRd mp{map};
    MM::template mm<P, P, P>(mp, LM, 1, SmemRd{X}, LS, 1, Wb, LS);
    const SmemRd Cm = mp.at(2 * P);
    MM::template mm<P, P, P>(SmemRd{Wb}, LS, 1, mp.at(P), 1, LM, out, LS, &Cm, LM);
  }
  // The look-back's merge of runs: with kDot2 the same products
  // compensated, over the larger order's terms (the padding's are zero).
  template <class LR>
  __device__ void merge_lb(const Acc* e, LR l, Acc* out, Acc* Wb) const {
    if constexpr (kDot2) {
      const int k = m > cols ? m : cols;
      const LR Bl = l.at(P), Cl = l.at(2 * P);
      MM::template mm2<P, P, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM, k);
      MM::template mm2<P, P, P>(Bl, LM, 1, SmemRd{e + P}, LM, 1, out + P, LM, k);
      MM::template mm2<P, P, P>(l, LM, 1, SmemRd{e + 2 * P}, LM, 1, Wb, LS, k);
      MM::template mm2<P, P, P>(SmemRd{Wb}, LS, 1, Bl, 1, LM, out + 2 * P, LM, k, &Cl, LM);
    } else {
      merge(e, l, out, Wb);
    }
  }
};

// By one warp: [M | R] (P x 2P, row stride ld) to [. | M^-1 R] by
// Gauss-Jordan elimination with partial pivoting (the first largest
// pivot), lane j holding column j in registers. At the orders here the
// merges' I + F G is not reliably near the identity. Columns
// m..P-1 are the padding's identity, whose steps change nothing, so they
// are skipped. Ends with the warp's barrier.
template <int P>
__device__ __noinline__ void warp_gj(Acc* W, int ld, int m) {
  const int lane = threadIdx.x & 31, j = lane % (2 * P);
  Acc w[P];
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = W[i * ld + j];
#pragma unroll
  for (int col = 0; col < P; ++col) {
    if (col >= m) break;
    int p = col;
    Acc best = fabs(w[col]);
#pragma unroll
    for (int i = col + 1; i < P; ++i)
      if (fabs(w[i]) > best) {
        best = fabs(w[i]);
        p = i;
      }
    p = __shfl_sync(0xffffffffu, p, col);
    Acc fac[P];
#pragma unroll
    for (int i = 0; i < P; ++i) fac[i] = __shfl_sync(0xffffffffu, w[i], col);
    Acc wp = w[col], fp = fac[col];
#pragma unroll
    for (int i = col + 1; i < P; ++i)
      if (i == p) {
        wp = w[i];
        fp = fac[i];
        w[i] = w[col];
        fac[i] = fac[col];
      }
    w[col] = wp * __drcp_rn(fp);
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i != col) w[i] -= fac[i] * w[col];
  }
  __syncwarp();
  if (lane >= P && lane < 2 * P)
#pragma unroll
    for (int i = 0; i < P; ++i) W[i * ld + lane] = w[i];
  __syncwarp();
}

// warp_gj above 16, by a block's first two warps, in place in shared
// memory: thread j updates column j of [M | R] (2P up to 64 wide). Rows
// are not swapped: at step col the first warp finds the largest entry of
// column col among the rows not yet pivots (lane i row i, the first such;
// a reduction by shuffles), and publishes its row in column 2P + 2 of row
// col and the column in padding column 2P or 2P + 1 (alternating, so that
// one barrier of the two warps a step suffices); every thread then scales
// the pivot row and eliminates the others in its own column, its loads
// first. Row perm[c]
// holds row c of M^-1 R at the end, which the R columns' threads put in
// place. Rows m..P-1 (the padding's identity) stay as they are. Ends with
// the block's barrier.
template <int P>
__device__ void block_gj(Acc* W, int ld, int m) {
  static_assert(2 * P <= 64, "two warps");
  const int j = threadIdx.x;
  Acc* perm = W + 2 * P + 2;  // perm[c * ld]: the pivot row of column c
  if (j < 64) {
    unsigned used = 0;
    for (int col = 0; col < m; ++col) {
      Acc* fac = W + 2 * P + (col & 1);
      if (j < 32) {
        const Acc v = j < m ? W[j * ld + col] : Acc(0);
        Acc key = j < m && !(used >> j & 1u) ? fabs(v) : Acc(-1);
        int p = j;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const Acc k2 = __shfl_xor_sync(0xffffffffu, key, off);
          const int p2 = __shfl_xor_sync(0xffffffffu, p, off);
          if (k2 > key || (k2 == key && p2 < p)) {
            key = k2;
            p = p2;
          }
        }
        if (j < m) fac[j * ld] = v;
        if (j == 0) perm[col * ld] = Acc(p);
      }
      asm volatile("bar.sync 1, 64;" ::: "memory");
      const int p = (int)perm[col * ld];
      used |= 1u << p;
      if (j < 2 * P && (j > col || j >= P)) {
        // Every load before any store (W and fac share the array).
        Acc f[P], w[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          f[i] = i < m ? fac[i * ld] : Acc(0);
          w[i] = i < m ? W[i * ld + j] : Acc(0);
        }
        const Acc np = W[p * ld + j] * __drcp_rn(fac[p * ld]);
#pragma unroll
        for (int i = 0; i < P; ++i)
          if (i < m) W[i * ld + j] = i == p ? np : w[i] - f[i] * np;
      }
    }
    asm volatile("bar.sync 1, 64;" ::: "memory");
    if (j >= P && j < 2 * P) {
      Acc v[P];
#pragma unroll
      for (int c = 0; c < P; ++c) v[c] = c < m ? W[(int)perm[c * ld] * ld + j] : W[c * ld + j];
#pragma unroll
      for (int c = 0; c < P; ++c) W[c * ld + j] = v[c];
    }
  }
  __syncthreads();
}

// The Riccati merges' Gauss-Jordan elimination by MM's threads: one warp's,
// or a block's first two.
template <class MM, int P>
__device__ __forceinline__ void ric_gj(Acc* W, int ld, int m) {
  if constexpr (MM::kThreads == 32)
    warp_gj<P>(W, ld, m);
  else
    block_gj<P>(W, ld, m);
}

// The Riccati flow at padded order P. A map in shared memory is P x 3P,
// [A | F | G], row stride LM; a state P x P, stride LS; the merge's
// scratch P x 2P, stride LW (each stride 4 mod 16 doubles apart from a
// multiple of 16: a warp's fragment loads fall in distinct banks). MM runs
// the products of maps in shared memory (quasisep_tc.cuh: WarpMM).
template <int P, class MM = WarpMM>
struct RicOp {
  static constexpr int H = P / 8, LM = 3 * P + 4, LS = P + 4, LW = 2 * P + 4;
  static constexpr int kMap = P * LM, kState = P * LS, kScratch = P * LW;
  static constexpr int kKind = gRic, kMaxComps = 1 + 2 * P + P * P;

  // A team's running value: A^T, F, G.
  struct Run {
    Frag<P, P> At, F, G;
  };
  // An element: d, p and q at the lane's rows, p at its columns, a.
  struct El {
    Acc d, pr[H], pc[H][2], qr[H];
    Frag<P, P> a;
  };

  int m, cols;  // the order; cols is unused (one chain)
  __device__ static int comps(int m, int) { return 1 + 2 * m + m * m; }

  // Element i of the staged tile (component c at st[c * LD + i]).
  template <typename S>
  __device__ __forceinline__ void load(const S* st, int LD, int i, El& e) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    e.d = Acc(st[i]);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int r = 8 * h + g;
      e.pr[h] = r < m ? Acc(st[(1 + r) * LD + i]) : Acc(0);
      e.qr[h] = r < m ? Acc(st[(1 + m + r) * LD + i]) : Acc(0);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 8 * h + 2 * t + jj;
        e.pc[h][jj] = c < m ? Acc(st[(1 + c) * LD + i]) : Acc(0);
      }
    }
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          e.a.v[k][h][jj] =
              r < m && c < m ? Acc(st[(1 + 2 * m + r * m + c) * LD + i]) : Acc(0);
        }
  }

  __device__ static void identity(Run& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          x.At.v[k][h][jj] = 8 * h + g == 8 * k + 2 * t + jj ? Acc(1) : Acc(0);
          x.F.v[k][h][jj] = x.G.v[k][h][jj] = Acc(0);
        }
  }

  // f = F p, c = d - p^T f and u = q - a f (u at the lane's rows and
  // columns).
  __device__ static Acc emit(const Frag<P, P>& F, const El& e, Acc (&ur)[H], Acc (&uc)[H][2]) {
    Acc f[H], fc[H][2], af[H];
    rowdot(F, e.pc, f);
    const Acc c = e.d - row_sum<P>(e.pr, f);
    to_cols<P>(f, fc);
    rowdot(e.a, fc, af);
#pragma unroll
    for (int h = 0; h < H; ++h) ur[h] = e.qr[h] - af[h];
    to_cols<P>(ur, uc);
    return c;
  }

  // F <- (a F^T) a^T + u u^T / c, ic = 1 / c.
  __device__ static void step_f(Frag<P, P>& F, const El& e, const Acc (&ur)[H],
                                const Acc (&uc)[H][2], Acc ic) {
    Frag<P, P> Z;
    xzt(e.a, F, Z);
    xzt(Z, e.a, F);
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) F.v[k][h][jj] += ur[h] * uc[k][jj] * ic;
  }

  // The element folded after the running value (the rank-one step).
  __device__ static void fold(Run& x, const El& e) {
    Acc ur[H], uc[H][2], w[H], wc[H][2];
    const Acc ic = Acc(1) / emit(x.F, e, ur, uc);
    rowdot(x.At, e.pc, w);  // w = A^T p
    to_cols<P>(w, wc);
    Frag<P, P> T;
    xzt(x.At, e.a, T);
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          x.At.v[k][h][jj] = T.v[k][h][jj] - w[h] * uc[k][jj] * ic;
          x.G.v[k][h][jj] -= w[h] * wc[k][jj] * ic;
        }
    step_f(x.F, e, ur, uc, ic);
  }

  // The running value into a map in shared memory.
  __device__ static void store(const Run& x, Acc* map) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          map[c * LM + r] = x.At.v[k][h][jj];
          map[r * LM + P + c] = x.F.v[k][h][jj];
          map[r * LM + 2 * P + c] = x.G.v[k][h][jj];
        }
    __syncwarp();
  }

  // The walk's state F from shared memory, and one step of the walk.
  struct State {
    Frag<P, P> F;
  };
  __device__ static void load_state(const Acc* s, State& x) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) x.F.v[k][h][jj] = s[(8 * h + g) * LS + 8 * k + 2 * t + jj];
  }
  __device__ static void walk(State& x, const El& e) {
    Acc ur[H], uc[H][2];
    const Acc ic2 = Acc(1) / emit(x.F, e, ur, uc);
    step_f(x.F, e, ur, uc, ic2);
  }
  // The state as element i's output, over its staged a (the lane's own
  // entries of a, which it has read).
  template <typename S>
  __device__ __forceinline__ void put(const State& x, S* st, int LD, int i) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 8 * h + g, c = 8 * k + 2 * t + jj;
          if (r < m && c < m) st[(1 + 2 * m + r * m + c) * LD + i] = S(x.F.v[k][h][jj]);
        }
  }
  // Output row q of the tile's staged component: the state entry q.
  __device__ int out_comp(int q) const { return 1 + 2 * m + q; }
  __device__ int out_rows() const { return m * m; }
  // An element in a map's place (wide_tile): a in A's, p and q in F's
  // first two columns, d after them in row 0; a state entry q.
  __device__ int el_slot(int c) const {
    return c == 0       ? P + 2
           : c <= m     ? (c - 1) * LM + P
           : c <= 2 * m ? (c - 1 - m) * LM + P + 1
                        : (c - 1 - 2 * m) / m * LM + (c - 1 - 2 * m) % m;
  }
  __device__ int state_slot(int q) const { return q / m * LS + q % m; }

  // The identity map, by MM's threads.
  __device__ static void identity_map(Acc* map) {
    for (int p = MM::tid(); p < kMap; p += MM::kThreads) {
      const int r = p / LM, c = p % LM;
      map[p] = c == r ? Acc(1) : Acc(0);
    }
    MM::sync();
  }

  // The rank-one step on maps in shared memory (wide_tile), by a block:
  // for the element el (el_slot's places), the state F (row stride ldf)
  // and, in a fold, the running A: f = F p and w = A^T p, then
  // u = q - a f and c = d - p^T f, into vec (f, w, u, 1 / c, c).
  __device__ void emit_map(const Acc* F, int ldf, const Acc* A, const Acc* el, Acc* vec) const {
    const int t = threadIdx.x;
    if (t < P) {
      Acc f = Acc(0);
      for (int k = 0; k < m; ++k) f += F[t * ldf + k] * el[k * LM + P];
      vec[t] = f;
    } else if (A && t < 2 * P) {
      Acc w = Acc(0);
      for (int k = 0; k < m; ++k) w += A[k * LM + t - P] * el[k * LM + P];
      vec[t] = w;
    }
    MM::sync();
    if (t < P) {
      Acc af = Acc(0);
      for (int k = 0; k < m; ++k) af += el[t * LM + k] * vec[k];
      vec[2 * P + t] = el[t * LM + P + 1] - af;
    } else if (t == P) {
      Acc pf = Acc(0);
      for (int k = 0; k < m; ++k) pf += el[k * LM + P] * vec[k];
      const Acc c = el[P + 2] - pf;
      vec[3 * P] = Acc(1) / c;
      vec[3 * P + 1] = c;
    }
    MM::sync();
  }

  // The element el folded after the running map cur into nxt:
  // A' = a A - u w^T / c, F' = (a F) a^T + u u^T / c, G' = G - w w^T / c.
  // Wb: kScratch values; vec: 4P.
  __device__ void fold_map(const Acc* cur, const Acc* el, Acc* nxt, Acc* Wb, Acc* vec) const {
    emit_map(cur + P, LM, cur, el, vec);
    const Acc ic = vec[3 * P];
    for (int p = MM::tid(); p < P * P; p += MM::kThreads) {
      const int r = p / P, c = p % P;
      const Acc wr = vec[P + r], ur = vec[2 * P + r];
      nxt[r * LM + c] = -ur * vec[P + c] * ic;
      nxt[r * LM + P + c] = ur * vec[2 * P + c] * ic;
      nxt[r * LM + 2 * P + c] = cur[r * LM + 2 * P + c] - wr * vec[P + c] * ic;
    }
    MM::sync();
    const SmemRd es{el}, An{nxt}, Fn{nxt + P};
    MM::template mm<P, P, P>(es, LM, 1, SmemRd{cur}, LM, 1, nxt, LM, &An, LM);  // a A + .
    MM::template mm<P, P, P>(es, LM, 1, SmemRd{cur + P}, LM, 1, Wb, LW);       // a F
    MM::template mm<P, P, P>(SmemRd{Wb}, LW, 1, es, 1, LM, nxt + P, LM, &Fn, LM);
  }

  // The walk's step on the state F (stride LS) in shared memory:
  // F' = (a F) a^T + u u^T / c2.
  __device__ void walk_map(Acc* F, const Acc* el, Acc* Wb, Acc* vec) const {
    emit_map(F, LS, nullptr, el, vec);
    const SmemRd es{el}, Fs{F};
    MM::template mm<P, P, P>(es, LM, 1, Fs, LS, 1, Wb, LW);  // a F
    const Acc ic = vec[3 * P];
    for (int p = MM::tid(); p < P * P; p += MM::kThreads) {
      const int r = p / P, c = p % P;
      F[r * LS + c] = vec[2 * P + r] * vec[2 * P + c] * ic;
    }
    MM::sync();
    MM::template mm<P, P, P>(SmemRd{Wb}, LW, 1, es, 1, LM, F, LS, &Fs, LS);
  }

  // out = the Moebius merge of the earlier map e and the later l
  // (cuda_loglik._ric_combine): with W = (I + F_e G_l)^-1,
  //   A = A_l (W A_e),  F = F_l + (A_l (W F_e)) A_l^T,
  //   G = G_e + (A_e^T (W^T G_l)) A_e.
  // out aliases neither e nor l; Wb: kScratch values.
  template <class LR>
  __device__ void merge(const Acc* e, LR l, Acc* out, Acc* Wb) const {
    const SmemRd es{e};
    MM::template mm<P, P, P>(es.at(P), LM, 1, l.at(2 * P), LM, 1, Wb, LW, (const SmemRd*)nullptr, 0, true);
    for (int p = MM::tid(); p < P * P; p += MM::kThreads) Wb[(p / P) * LW + P + p % P] = p / P == p % P;
    MM::sync();
    ric_gj<MM, P>(Wb, LW, m);
    const SmemRd W{Wb + P};
    MM::template mm<P, P, P>(W, 1, LW, l.at(2 * P), LM, 1, out + 2 * P, LM);      // W^T G_l
    MM::template mm<P, 2 * P, P>(W, LW, 1, es, LM, 1, out, LM);                    // W [A_e | F_e]
    MM::template mm<P, 2 * P, P>(l, LM, 1, SmemRd{out}, LM, 1, out, LM);           // [A | A_l W F_e]
    MM::template mm<P, P, P>(es, 1, LM, SmemRd{out + 2 * P}, LM, 1, Wb + P, LW);  // A_e^T W^T G_l
    const LR Fl = l.at(P);
    MM::template mm<P, P, P>(SmemRd{out + P}, LM, 1, l, 1, LM, out + P, LM, &Fl, LM);  // F
    const SmemRd Ge = es.at(2 * P);
    MM::template mm<P, P, P>(SmemRd{Wb + P}, LW, 1, es, LM, 1, out + 2 * P, LM, &Ge, LM);  // G
  }

  // The look-back's merge of runs of tiles (mono_lookback): the same.
  template <class LR>
  __device__ void merge_lb(const Acc* e, LR l, Acc* out, Acc* Wb) const { merge(e, l, out, Wb); }

  // out = the state X after the map (cuda_loglik._ric_apply):
  // F + A ((I + X G)^-1 X) A^T. out may alias X, not map; Wb: kScratch.
  __device__ void apply(const Acc* map, const Acc* X, Acc* out, Acc* Wb) const {
    const SmemRd mp{map};
    MM::template mm<P, P, P>(SmemRd{X}, LS, 1, mp.at(2 * P), LM, 1, Wb, LW, (const SmemRd*)nullptr, 0, true);
    for (int p = MM::tid(); p < P * P; p += MM::kThreads) Wb[(p / P) * LW + P + p % P] = X[(p / P) * LS + p % P];
    MM::sync();
    ric_gj<MM, P>(Wb, LW, m);
    MM::template mm<P, P, P>(mp, LM, 1, SmemRd{Wb + P}, LW, 1, Wb, LW);  // A Y
    const SmemRd F = mp.at(P);
    MM::template mm<P, P, P>(SmemRd{Wb}, LW, 1, mp, 1, LM, out, LS, &F, LM);
  }
};

// The in-tile Kogge-Stone scan of the teams' maps, each in its buf(w, 0),
// by every thread of the block: team w's inclusive value ends in buf(w, 0)
// (buffer 1 is scratch).
template <class Op, class Buf, class Scr>
__device__ void mono_team_scan(const Op& op, Buf buf, Scr scr) {
  static_assert(kMonoTeams == 4, "two rounds of merges");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  for (int off = 1, k = 0; off < kMonoTeams; off <<= 1, k ^= 1) {
    if (w >= off) {
      op.merge(buf(w - off, k), SmemRd{buf(w, k)}, buf(w, k ^ 1), scr(w));
    } else {
      for (int e = lane; e < Op::kMap; e += 32) buf(w, k ^ 1)[e] = buf(w, k)[e];
      __syncwarp();
    }
    __syncthreads();
  }
}

// By team w: its state at its first element into x, the prefix of the
// teams before it (buf(w - 1, 0) after mono_team_scan) applied to the
// tile's start.
template <class Op, class Buf, class Scr>
__device__ void mono_team_start(const Op& op, Buf buf, Scr scr, const Acc* start, Acc* x) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w > 0) {
    op.apply(buf(w - 1, 0), start, x, scr(w));
  } else {
    for (int c = lane; c < Op::kState; c += 32) x[c] = start[c];
    __syncwarp();
  }
}

// The block's part of the look-back (quasisep_generic.cu: cpl_lookback's
// association over Op's maps, in groups of kMonoGroup tiles), once the
// tile's aggregate agg is final: Q folded in runs of kMonoRun tiles, warp
// r folding run r in order, reading each aggregate through L2; the runs
// composed as (run 0 . run 1) . (run 2 . run 3); warp 0 finds the state
// after the group before, publishes, and leaves the state before tile b
// in st. The Riccati merge costs a few microseconds (a pivoted inverse on
// one warp), so groups are 16 tiles and not 32: the fold's depth is 3 + 2
// merges, against a longer chain over groups (PERF.md). A run's fold and
// the group's aggregate merge one tile's aggregate after what came before,
// a short span, with the Op's merge; the merges of runs, the Op's
// merge_lb.
// buf(v, k) is team v's map buffer k (1 and 2 are free here), scr(v) its
// merge scratch.
template <class Op, class Buf, class Scr>
__device__ void mono_lookback(const Op& op, long long b, long long nt, const LookSlots& sl,
                              const Acc* agg, Acc* lk, Acc* st, Acc* s, Buf buf, Scr scr) {
  constexpr int MAP = Op::kMap, ST = Op::kState;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long g = b / kMonoGroup, base = g * kMonoGroup;
  const bool end = b % kMonoGroup == kMonoGroup - 1, more = b + 1 < nt;
  const int cnt = (int)(b - base);
  if (w == 0) {
    if (!end && more) publish_values(agg, sl.tile_agg + b * MAP, MAP, sl.tile_flag + b, 1u);
    if (lane < cnt) wait_nonzero(sl.tile_flag + base + lane);
  }
  __syncthreads();
  __threadfence();
  const auto len = [&](int r) { return max(0, min(kMonoRun, cnt - kMonoRun * r)); };
  const auto run_map = [&](int r) { return buf(r, 1 + ((len(r) - 1) & 1)); };
  if (len(w) > 0) {
    const Acc* src = sl.tile_agg + (base + kMonoRun * w) * MAP;
    Acc* P = buf(w, 1);
    Acc* Pn = buf(w, 2);
    for (int c = lane; c < MAP; c += 32) P[c] = __ldcg(src + c);
    __syncwarp();
    for (int i = 1; i < len(w); ++i) {
      op.merge(P, L2Rd{src + i * MAP}, Pn, scr(w));
      Acc* swap = P;
      P = Pn;
      Pn = swap;
    }
  }
  __syncthreads();
  Acc *Q = lk, *GA = lk + MAP, *win = lk + 2 * MAP;  // R0 . R1 goes to win
  const Acc* R0 = run_map(0);
  const Acc* R2 = run_map(2);
  if (len(1) > 0) {
    if (w == 0) op.merge_lb(R0, SmemRd{run_map(1)}, win, scr(0));
    R0 = win;
  }
  if (len(3) > 0) {
    Acc* out = buf(2, 2 - ((len(2) - 1) & 1));
    if (w == 2) op.merge_lb(R2, SmemRd{run_map(3)}, out, scr(2));
    R2 = out;
  }
  __syncthreads();
  if (w != 0) return;
  if (cnt == 0) {
    Op::identity_map(Q);
  } else if (len(2) > 0) {
    op.merge_lb(R0, SmemRd{R2}, Q, scr(0));
  } else {
    for (int c = lane; c < MAP; c += 32) Q[c] = R0[c];
    __syncwarp();
  }
  if (end && more) {
    op.merge(Q, SmemRd{agg}, GA, scr(0));
    publish_values(GA, sl.group_agg + g * MAP, MAP, sl.group_flag + g, 1u);
  }
  // S(g - 1): from the nearest group whose end state is published, the
  // groups after it applied one at a time through the window.
  const long long j = lookback_find(g, sl.group_flag);
  for (int c = lane; c < ST; c += 32) s[c] = j >= 0 ? __ldcg(sl.group_state + j * ST + c) : Acc(0);
  __syncwarp();
  for (long long i = j + 1; i < g; ++i) {
    lookback_window(sl.group_agg, i, 1, MAP, win);
    op.apply(win, s, s, scr(0));
  }
  op.apply(Q, s, st, scr(0));
  if (end && more) {
    op.apply(GA, s, s, scr(0));
    publish_values(s, sl.group_state + g * ST, ST, sl.group_flag + g, 2u);
  }
}

// ------------------------------------------ kernels B1, B1r and B2 above m = 4
//
// What their one-launch kernels share (quasisep_loglik_generic.cu up to
// m = 16, quasisep_loglik_wide.cu above): the operands, B1's workspace and
// the finish of its two sums.

// B1 and B1r: operands (d, ps, qs, as, y) and the outputs out (quad,
// logdet) and, for B1r (Fs non-null), the residuals Fs, es, ics.
template <typename S>
struct FwdArgs {
  const S *d, *ps, *qs, *as, *y;
  S *out, *Fs, *es, *ics;
};

// B2: the residuals and cotangents in, the operands' cotangents out.
template <typename S>
struct BwdArgs {
  const S *ps, *qs, *as, *y, *Fs, *es, *ics, *qbar, *lbar;
  S *dbar, *psbar, *qsbar, *asbar, *ybar;
};

// B1's workspace, in Acc: two chains of look-back slots (the Riccati
// flow's, then the whitening scan's, each in the larger map and state), the
// ticket and the flags, one more 32-bit word (the finish ticket), then
// each tile's two partial sums. One memset zeroes the words.
struct FwdLayout {
  ChainLayout chain;
  long long partials, total;
  __host__ __device__ FwdLayout(long long nt, int map, int state)
      : chain(nt, 2, map, state, kMonoGroup) {
    partials = chain.flags + (chain.flag_words + 2) / 2;
    total = partials + 2 * nt;
  }
  __host__ __device__ long long zero_bytes() const {
    return (chain.flag_words + 1) * (long long)sizeof(unsigned);
  }
  __device__ unsigned* finished(Acc* work) const { return chain.ticket(work) + chain.flag_words; }
};

// By every thread of the block, with the tile's two sums in thread 0:
// publish them, and in the tile that finishes last (counted on the finish
// ticket) sum every tile's in tile order, each thread a strided run and
// then a fixed tree, into out; red holds 2 blockDim.x values. So two
// launches on the same inputs agree bit for bit.
template <typename S>
__device__ void b1_finish(long long b, long long nt, Acc quad, Acc logdet, const FwdLayout& lay,
                          Acc* work, Acc* red, S* out) {
  __shared__ bool last;
  const int t = threadIdx.x, nthr = blockDim.x;
  Acc* partials = work + lay.partials;
  if (t == 0) {
    partials[2 * b] = quad;
    partials[2 * b + 1] = logdet;
    __threadfence();
    last = atomicAdd(lay.finished(work), 1u) == (unsigned)(nt - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  Acc q = Acc(0), l = Acc(0);
  for (long long i = t; i < nt; i += nthr) {
    q += __ldcg(partials + 2 * i);
    l += __ldcg(partials + 2 * i + 1);
  }
  red[t] = q;
  red[nthr + t] = l;
  __syncthreads();
  for (int h = nthr / 2; h > 0; h >>= 1) {
    if (t < h) {
      red[t] += red[t + h];
      red[nthr + t] += red[nthr + t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = S(red[0]);
    out[1] = S(red[nthr]);
  }
}

}  // namespace
