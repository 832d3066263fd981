// The float64 tensor-core pieces of the one-launch generic-order scans on
// Hopper (sm_90a), shared by kernel B3 (quasisep_generic.cu:
// ric_tile_kernel, aff_tile_kernel, cong_tile_kernel) and kernel B2 above
// m = 8 (quasisep_loglik_generic.cu: b2_tc_kernel): a warp's matrices in
// the layout of mma.sync.m16n8k8.f64's accumulator (Frag) and their
// products (xzt, smm), the affine and congruence monoids as the one-launch
// skeleton's Ops (AffOp, CongOp; the Riccati flow's RicOp stays beside its
// only kernel), and the skeleton's grouped look-back (mono_lookback).
//
// An Op holds a warp team's running map in registers (Run), an element
// (El), the walk's state (State) and, for maps in shared memory, the merge
// of an earlier map with a later one and a map's application to a state,
// both by one warp on the tensor cores. Orders up to P are padded with
// zeros, which every product keeps.

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

// By warp 0: publish `size` values of src at dst, then set *flag to v.
__device__ __forceinline__ void publish_values(const Acc* src, Acc* dst, int size, unsigned* flag,
                                            unsigned v) {
  for (int c = threadIdx.x; c < size; c += 32) dst[c] = src[c];
  __threadfence();
  __syncwarp();
  if (threadIdx.x == 0) st_release(flag, v);
}

// The affine scan at padded order P with RC columns a group: a map is
// P x (P + RC), [A | B], row stride LM; a state P x RC, stride LS.
template <int P, int RC>
struct AffOp {
  static constexpr int H = P / 8, HX = (P + RC) / 8, HS = RC / 8;
  static constexpr int LM = P + RC + 4, LS = RC + 4;
  static constexpr int kMap = P * LM, kState = P * LS, kScratch = 0;
  static constexpr int kKind = gAff;

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

  __device__ static void identity_map(Acc* map) {
    for (int p = threadIdx.x & 31; p < kMap; p += 32) {
      const int r = p / LM, c = p % LM;
      map[p] = c == r ? Acc(1) : Acc(0);
    }
    __syncwarp();
  }
  // out = (A_l A_e, A_l B_e + B_l); out aliases neither.
  template <class LR>
  __device__ void merge(const Acc* e, LR l, Acc* out, Acc*) const {
    const LR Bl = l.at(P);
    smm<P, P + RC, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM, &Bl, LM, false, P);
  }
  // out = A s + B; out may alias s.
  __device__ void apply(const Acc* map, const Acc* s, Acc* out, Acc*) const {
    const SmemRd Bm{map + P};
    smm<P, RC, P>(SmemRd{map}, LM, 1, SmemRd{s}, LS, 1, out, LS, &Bm, LM);
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
template <int P, bool kDot2>
struct CongOp {
  static constexpr int H = P / 8, LM = 2 * P + 4, LS = P + 4;
  static constexpr int kMap = P * LM, kState = P * LS, kScratch = P * LS;
  static constexpr int kKind = gCong;

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

  __device__ static void identity_map(Acc* map) {
    for (int p = threadIdx.x & 31; p < kMap; p += 32) {
      const int r = p / LM, c = p % LM;
      map[p] = c == r ? Acc(1) : Acc(0);
    }
    __syncwarp();
  }
  // out = (A_l A_e, (A_l B_e) A_l^T + B_l) of the earlier map e and the
  // later l: three products; out aliases neither.
  template <class LR>
  __device__ void merge(const Acc* e, LR l, Acc* out, Acc*) const {
    smm<P, 2 * P, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM);  // A_l [A_e | B_e]
    const LR Bl = l.at(P);
    smm<P, P, P>(SmemRd{out + P}, LM, 1, l, 1, LM, out + P, LM, &Bl, LM);
  }
  // out = (A X) A^T + B; out may alias X, not map; Wb: kScratch values.
  __device__ void apply(const Acc* map, const Acc* X, Acc* out, Acc* Wb) const {
    const SmemRd mp{map};
    smm<P, P, P>(mp, LM, 1, SmemRd{X}, LS, 1, Wb, LS);
    const SmemRd Bm = mp.at(P);
    smm<P, P, P>(SmemRd{Wb}, LS, 1, mp, 1, LM, out, LS, &Bm, LM);
  }
  // The look-back's merge of runs: with kDot2 the same products
  // compensated, over the order's m terms (the padding's are zero). Both
  // products need it: A_l B_e's rounding is multiplied by A_l again.
  template <class LR>
  __device__ void merge_lb(const Acc* e, LR l, Acc* out, Acc* Wb) const {
    if constexpr (kDot2) {
      smm2<P, 2 * P, P>(l, LM, 1, SmemRd{e}, LM, 1, out, LM, m);
      const LR Bl = l.at(P);
      smm2<P, P, P>(SmemRd{out + P}, LM, 1, l, 1, LM, out + P, LM, m, &Bl, LM);
    } else {
      merge(e, l, out, Wb);
    }
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

}  // namespace
