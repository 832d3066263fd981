// The block-a-team pieces of the one-launch scans above order 16 on Hopper
// (sm_90a), shared by kernel B3 (quasisep_wide.cu: the *_wide_kernel) and
// kernels B1, B1r and B2 above m = 16 (quasisep_loglik_wide.cu): a
// block's products of maps on the float64 tensor cores (bmm, bmm2: BlockMM
// for quasisep_tc.cuh's Ops), the Ops' merges, applications and steps as
// functions called, not inlined (w_*), the block's grouped look-back
// (wide_lookback) and the sizing of a streamed chunk (wide_chunk). See
// quasisep_wide.cu for the design.

#pragma once

#include "quasisep_tc.cuh"

namespace {

constexpr int kWideMinM = 17;   // the smallest (larger) order here
constexpr int kWideWarps = 4;   // warps of a team (a block)
constexpr int kWideTile = 32;   // elements a tile; the Riccati flow's, twice (wide_tile_len)
constexpr int kWideMaps = 5;    // maps the look-back holds at once: its aggregate and 4
constexpr int kWideFoldMaps = 3;  // of them outside the staged chunk: the running map's two, the element
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideCols = 16;   // affine columns a group

// By a block: smm's D (R x N) = X Y [+ E] [+ I], with the same operands and
// layout, warp w computing the output's 16 x 8 tiles w, w + kWideWarps, ...
// Every operand is read before any entry is written. Ends with the block's
// barrier.
template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
__device__ __forceinline__ void bmm(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld,
                                    const ER* E = nullptr, int le = 0, bool eye = false,
                                    int e0 = 0) {
  constexpr int MT = (R + 15) / 16, NT = N / 8, TILES = MT * NT;
  constexpr int TW = (TILES + kWideWarps - 1) / kWideWarps;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  Acc c[TW][4];
#pragma unroll
  for (int q = 0; q < TW; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[q][i] = Acc(0);
#pragma unroll
  for (int kt = 0; kt < K / 8; ++kt)
#pragma unroll
    for (int q = 0; q < TW; ++q) {
      const int tile = w + kWideWarps * q;
      if (tile < TILES) {
        const int mt = tile / NT, nt = tile % NT;
        Acc a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * mt + g + 8 * (i & 1);
          a[i] = r < R ? X[r * xr + (8 * kt + t + 4 * (i >> 1)) * xk] : Acc(0);
        }
        mma884(c[q], a[0], a[1], a[2], a[3], Y[(8 * kt + t) * yk + (8 * nt + g) * yn],
               Y[(8 * kt + t + 4) * yk + (8 * nt + g) * yn]);
      }
    }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < TW; ++q) {
    const int tile = w + kWideWarps * q;
    if (tile < TILES) {
      const int mt = tile / NT, nt = tile % NT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i >> 1), col = 8 * nt + 2 * t + (i & 1);
        if (r < R) {
          Acc v = c[q][i];
          if (E && col >= e0) v += (*E)[r * le + col - e0];
          if (eye && r == col) v += Acc(1);
          D[r * ld + col] = v;
        }
      }
    }
  }
  __syncthreads();
}

// By a block: smm2's compensated D = X Y [+ E], bmm's tiles to each warp.
template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
__device__ __forceinline__ void bmm2(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld,
                                     int k, const ER* E = nullptr, int le = 0) {
  constexpr int MT = (R + 15) / 16, NT = N / 8, TILES = MT * NT;
  constexpr int TW = (TILES + kWideWarps - 1) / kWideWarps;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  Acc s[TW][4], c[TW][4];
#pragma unroll
  for (int q = 0; q < TW; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[q][i] = c[q][i] = Acc(0);
#pragma unroll
  for (int q = 0; q < TW; ++q) {
    const int tile = w + kWideWarps * q;
    if (tile >= TILES) continue;
    const int mt = tile / NT, nt = tile % NT;
    for (int kk = 0; kk < k; ++kk) {
      Acc x[2], y[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        x[h] = r < R ? X[r * xr + kk * xk] : Acc(0);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) y[j] = Y[kk * yk + (8 * nt + 2 * t + j) * yn];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Acc a = x[i >> 1], b = y[i & 1];
        const Acc p = __dmul_rn(a, b), qq = __fma_rn(a, b, -p);
        Acc e;
        two_sum(s[q][i], p, s[q][i], e);
        c[q][i] = __dadd_rn(c[q][i], __dadd_rn(e, qq));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < TW; ++q) {
    const int tile = w + kWideWarps * q;
    if (tile < TILES) {
      const int mt = tile / NT, nt = tile % NT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i >> 1), col = 8 * nt + 2 * t + (i & 1);
        if (r < R) {
          Acc v = s[q][i], u = c[q][i];
          if (E) {
            Acc e;
            two_sum(v, (*E)[r * le + col], v, e);
            u = __dadd_rn(u, e);
          }
          D[r * ld + col] = __dadd_rn(v, u);
        }
      }
    }
  }
  __syncthreads();
}

// The Ops' products by a whole block (quasisep_tc.cuh: WarpMM).
struct BlockMM {
  static constexpr int kThreads = kWideThreads;
  __device__ static int tid() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
  __device__ static void mm(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld,
                            const ER* E = nullptr, int le = 0, bool eye = false, int e0 = 0) {
    bmm<R, N, K>(X, xr, xk, Y, yk, yn, D, ld, E, le, eye, e0);
  }
  template <int R, int N, int K, class XR, class YR, class ER = SmemRd>
  __device__ static void mm2(XR X, int xr, int xk, YR Y, int yk, int yn, Acc* D, int ld, int k,
                             const ER* E = nullptr, int le = 0) {
    bmm2<R, N, K>(X, xr, xk, Y, yk, yn, D, ld, k, E, le);
  }
};

// By a block: publish `size` values of src at dst, then set *flag to v.
__device__ __forceinline__ void wide_publish(const Acc* src, Acc* dst, int size, unsigned* flag,
                                             unsigned v) {
  for (int c = threadIdx.x; c < size; c += kWideThreads) dst[c] = src[c];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, v);
}

// Elements a tile: twice kWideTile for the Riccati flow, whose look-back
// merges and applications each take a pivoted inverse, so that the chain of
// groups' states (an application a group) is half as long.
__host__ __device__ constexpr int wide_tile_len(int kind) {
  return kind == gRic ? 2 * kWideTile : kWideTile;
}

// The Ops' merges, applications and steps, each one function (see above).
template <class Op, class LR>
__device__ __noinline__ void w_merge(Op op, const Acc* e, LR l, Acc* out, Acc* scr) {
  op.merge(e, l, out, scr);
}
template <class Op>
__device__ __noinline__ void w_merge_lb(Op op, const Acc* e, const Acc* l, Acc* out, Acc* scr) {
  op.merge_lb(e, SmemRd{l}, out, scr);
}
template <class Op>
__device__ __noinline__ void w_apply(Op op, const Acc* map, const Acc* x, Acc* out, Acc* scr) {
  op.apply(map, x, out, scr);
}
// The element el folded after the running map cur into nxt.
template <class Op>
__device__ __noinline__ void w_fold(Op op, const Acc* cur, const Acc* el, Acc* nxt, Acc* scr,
                                    Acc* vec) {
  if constexpr (Op::kKind == gRic)
    op.fold_map(cur, el, nxt, scr, vec);
  else
    op.merge(cur, SmemRd{el}, nxt, scr);
}
// The state x after the element el, in place.
template <class Op>
__device__ __noinline__ void w_walk(Op op, Acc* x, const Acc* el, Acc* scr, Acc* vec) {
  if constexpr (Op::kKind == gRic)
    op.walk_map(x, el, scr, vec);
  else
    op.apply(el, x, x, scr);
}

// By a block, once the tile's aggregate maps[agg] is final: the state
// before tile b into st (s is scratch), in mono_lookback's association,
// each merge and application by the whole block in turn. The other maps
// are a pool its folds take buffers from (four at most at once).
template <class Op>
__device__ void wide_lookback(Op op, long long b, long long nt, const LookSlots& sl, Acc* maps,
                              int agg, Acc* scr, Acc* st, Acc* s) {
  constexpr int MAP = Op::kMap, ST = Op::kState;
  __shared__ long long found;
  const int t = threadIdx.x;
  const auto buf = [&](int i) { return maps + i * MAP; };
  const long long g = b / kMonoGroup, base = g * kMonoGroup;
  const bool end = b % kMonoGroup == kMonoGroup - 1, more = b + 1 < nt;
  const int cnt = (int)(b - base);
  if (!end && more) wide_publish(buf(agg), sl.tile_agg + b * MAP, MAP, sl.tile_flag + b, 1u);
  if (t < cnt) wait_nonzero(sl.tile_flag + base + t);
  __syncthreads();
  __threadfence();
  unsigned used = 1u << agg;
  const auto take = [&]() {
    const int i = __ffs(~used) - 1;
    used |= 1u << i;
    return i;
  };
  const auto give = [&](int i) { used &= ~(1u << i); };
  // Run r covers the group's tiles [kMonoRun r, kMonoRun r + len(r)),
  // folded in order; the runs are composed as (run 0 . run 1) . (run 2 .
  // run 3).
  const auto len = [&](int r) { return max(0, min(kMonoRun, cnt - kMonoRun * r)); };
  int half[2] = {-1, -1};
#pragma unroll 1
  for (int r = 0; r < 4 && len(r) > 0; ++r) {
    const Acc* src = sl.tile_agg + (base + kMonoRun * r) * MAP;
    int cur = take(), nxt = take();
    for (int c = t; c < MAP; c += kWideThreads) buf(cur)[c] = __ldcg(src + c);
    __syncthreads();
    for (int i = 1; i < len(r); ++i) {
      w_merge(op, buf(cur), L2Rd{src + i * MAP}, buf(nxt), scr);
      const int swap = cur;
      cur = nxt;
      nxt = swap;
    }
    give(nxt);
    int& h = half[r >> 1];
    if (r & 1) {
      const int o = take();
      w_merge_lb(op, buf(h), buf(cur), buf(o), scr);
      give(h);
      give(cur);
      h = o;
    } else {
      h = cur;
    }
  }
  int Q = half[0];
  if (cnt == 0) {
    Q = take();
    Op::identity_map(buf(Q));
  } else if (half[1] >= 0) {
    Q = take();
    w_merge_lb(op, buf(half[0]), buf(half[1]), buf(Q), scr);
    give(half[0]);
    give(half[1]);
  }
  int GA = -1;
  if (end && more) {
    GA = take();
    w_merge(op, buf(Q), SmemRd{buf(agg)}, buf(GA), scr);
    wide_publish(buf(GA), sl.group_agg + g * MAP, MAP, sl.group_flag + g, 1u);
  }
  // S(g - 1): from the nearest group whose end state is published, the
  // groups after it applied one at a time.
  if (t < 32) {
    const long long j = lookback_find(g, sl.group_flag);
    if (t == 0) found = j;
  }
  __syncthreads();
  const long long j = found;
  for (int c = t; c < ST; c += kWideThreads) s[c] = j >= 0 ? __ldcg(sl.group_state + j * ST + c) : Acc(0);
  __syncthreads();
  const int win = take();
  for (long long i = j + 1; i < g; ++i) {
    for (int c = t; c < MAP; c += kWideThreads) buf(win)[c] = __ldcg(sl.group_agg + i * MAP + c);
    __syncthreads();
    w_apply(op, buf(win), s, s, scr);
  }
  w_apply(op, buf(Q), s, st, scr);
  if (end && more) {
    w_apply(op, buf(GA), s, s, scr);
    wide_publish(s, sl.group_state + g * ST, ST, sl.group_flag + g, 2u);
  }
}

// A block's shared memory beside its staged chunk, in bytes (fixed), the
// chunk's region for e elements of per bytes each (at least two maps of
// map bytes, which the look-back takes there), and the most elements a
// chunk, from e down by halves, whose block fits and leaves as many blocks
// a multiprocessor as a chunk of one, or two; and log2 of a power of 2.
__host__ __device__ constexpr long long wide_region(long long per, long long map, int e) {
  return (per * e > 2 * map ? per * e : 2 * map) + 15 & ~15LL;
}
__host__ __device__ constexpr long long wide_blocks(long long bytes) { return kGenSharedSM / (bytes + 1024); }
__host__ __device__ constexpr int wide_chunk(long long fixed, long long per, long long map, int e) {
  return e == 1 || (fixed + wide_region(per, map, e) <= kGenSharedBlock &&
                    wide_blocks(fixed + wide_region(per, map, e)) >=
                        (wide_blocks(fixed + wide_region(per, map, 1)) < 2
                             ? wide_blocks(fixed + wide_region(per, map, 1)) : 2))
             ? e
             : wide_chunk(fixed, per, map, e / 2);
}
__host__ __device__ constexpr int wide_log2(int e) { return e <= 1 ? 0 : 1 + wide_log2(e / 2); }

}  // namespace
