// Shared pieces of the quasiseparable kernels on Hopper (sm_90a): the m x m
// algebra with closed-form inverses, the Riccati and affine monoids and the
// Riccati element's sequential step; cp.async, the in-tile scan and the
// one-launch look-back of kernels B1 and B1r (quasisep_loglik.cu), B2
// (quasisep_loglik_bwd.cu, and quasisep_loglik_generic.cu at m = 5..16) and
// B3 (quasisep_scan.cu, and quasisep_generic.cu's one-launch scans).
// Its last section, a warp's product at any order, serves
// quasisep_loglik_generic.cu's b2_warp_kernel.

#pragma once

#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char qsl_smem[];

namespace {

// The arithmetic type of every scan (see Precision in quasisep_loglik.cu).
using Acc = double;

// ---------------------------------------------------------------- m x m algebra

template <typename T, int M>
__device__ __forceinline__ void mm(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = a[i * M] * b[j];
#pragma unroll
      for (int l = 1; l < M; ++l) acc += a[i * M + l] * b[l * M + j];
      out[i * M + j] = acc;
    }
}

// a @ b^T
template <typename T, int M>
__device__ __forceinline__ void mm_nt(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = a[i * M] * b[j * M];
#pragma unroll
      for (int l = 1; l < M; ++l) acc += a[i * M + l] * b[j * M + l];
      out[i * M + j] = acc;
    }
}

// a^T @ b
template <typename T, int M>
__device__ __forceinline__ void mm_tn(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = a[i] * b[j];
#pragma unroll
      for (int l = 1; l < M; ++l) acc += a[l * M + i] * b[l * M + j];
      out[i * M + j] = acc;
    }
}

template <typename T>
__device__ __forceinline__ void inv2(const T* x, T* out) {
  const T idet = T(1) / (x[0] * x[3] - x[1] * x[2]);
  out[0] = x[3] * idet;
  out[1] = -x[1] * idet;
  out[2] = -x[2] * idet;
  out[3] = x[0] * idet;
}

template <typename T>
__device__ __forceinline__ void mul2(const T* x, const T* y, T* out) {
  out[0] = x[0] * y[0] + x[1] * y[2];
  out[1] = x[0] * y[1] + x[1] * y[3];
  out[2] = x[2] * y[0] + x[3] * y[2];
  out[3] = x[2] * y[1] + x[3] * y[3];
}

// Closed-form inverses: adjugates for m <= 3 and the block-Schur form of
// scan.py:_inv4_components for m = 4. The scan merges invert I + F G,
// which is near the identity, so no pivoting is needed.
template <typename T, int M>
__device__ __forceinline__ void inverse(const T* x, T* out) {
  if constexpr (M == 1) {
    out[0] = T(1) / x[0];
  } else if constexpr (M == 2) {
    inv2(x, out);
  } else if constexpr (M == 3) {
    const T a = x[0], b = x[1], c = x[2], d = x[3], e = x[4], f = x[5],
            g = x[6], h = x[7], i = x[8];
    const T A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
    const T D = -(b * i - c * h), E = a * i - c * g, F = -(a * h - b * g);
    const T G = b * f - c * e, H = -(a * f - c * d), I = a * e - b * d;
    const T idet = T(1) / (a * A + b * B + c * C);
    out[0] = A * idet; out[1] = D * idet; out[2] = G * idet;
    out[3] = B * idet; out[4] = E * idet; out[5] = H * idet;
    out[6] = C * idet; out[7] = F * idet; out[8] = I * idet;
  } else {
    static_assert(M == 4, "m must be 1..4");
    const T p[4] = {x[0], x[1], x[4], x[5]};
    const T q[4] = {x[2], x[3], x[6], x[7]};
    const T r[4] = {x[8], x[9], x[12], x[13]};
    const T s[4] = {x[10], x[11], x[14], x[15]};
    T pinv[4], rpinv[4], tmp[4], t[4], tinv[4], pinvq[4], tl[4], tr[4];
    inv2(p, pinv);
    mul2(r, pinv, rpinv);
    mul2(rpinv, q, tmp);
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = s[k] - tmp[k];
    inv2(t, tinv);
    mul2(pinv, q, pinvq);
    mul2(tinv, rpinv, tl);  // T^-1 R P^-1
    mul2(pinvq, tinv, tr);  // P^-1 Q T^-1
    mul2(tr, rpinv, tmp);
    out[0] = pinv[0] + tmp[0]; out[1] = pinv[1] + tmp[1];
    out[4] = pinv[2] + tmp[2]; out[5] = pinv[3] + tmp[3];
    out[2] = -tr[0]; out[3] = -tr[1]; out[6] = -tr[2]; out[7] = -tr[3];
    out[8] = -tl[0]; out[9] = -tl[1]; out[12] = -tl[2]; out[13] = -tl[3];
    out[10] = tinv[0]; out[11] = tinv[1]; out[14] = tinv[2]; out[15] = tinv[3];
  }
}

// -------------------------------------------------------------------- monoids

// The Riccati flow as a Moebius map (A, F, G), flattened [A | F | G].
template <typename T, int M>
struct Ric {
  static constexpr int MM = M * M;
  static constexpr int S = 3 * MM;
  T v[S];

  __device__ static Ric identity() {
    Ric r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < MM && c % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // M = I + F_e G_l;  A = A_l M^-1 A_e;  F = F_l + A_l M^-1 F_e A_l^T;
  // G = G_e + A_e^T M^-T G_l A_e.
  __device__ static Ric combine(const Ric& e, const Ric& l) {
    const T* Ae = e.v; const T* Fe = e.v + MM; const T* Ge = e.v + 2 * MM;
    const T* Al = l.v; const T* Fl = l.v + MM; const T* Gl = l.v + 2 * MM;
    T mat[MM], minv[MM], t1[MM], t2[MM];
    mm<T, M>(Fe, Gl, mat);
#pragma unroll
    for (int i = 0; i < M; ++i) mat[i * (M + 1)] += T(1);
    inverse<T, M>(mat, minv);
    Ric out;
    mm<T, M>(minv, Ae, t1);
    mm<T, M>(Al, t1, out.v);
    mm<T, M>(minv, Fe, t1);
    mm<T, M>(Al, t1, t2);
    mm_nt<T, M>(t2, Al, t1);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[MM + c] = Fl[c] + t1[c];
    mm_tn<T, M>(minv, Gl, t1);
    mm<T, M>(t1, Ae, t2);
    mm_tn<T, M>(Ae, t2, t1);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[2 * MM + c] = Ge[c] + t1[c];
    return out;
  }
};

// The affine recurrence g' = A g + B with C columns sharing A, flattened
// [A (M x M) | B (M x C)], B row-major.
template <typename T, int M, int C = 1>
struct Aff {
  static constexpr int MM = M * M;
  static constexpr int S = MM + M * C;
  T v[S];

  __device__ static Aff identity() {
    Aff r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < MM && c % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // (A_l A_e, A_l B_e + B_l)
  __device__ static Aff combine(const Aff& e, const Aff& l) {
    Aff out;
    mm<T, M>(l.v, e.v, out.v);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int k = 0; k < C; ++k) {
        T acc = l.v[MM + i * C + k];
#pragma unroll
        for (int j = 0; j < M; ++j) acc += l.v[i * M + j] * e.v[MM + j * C + k];
        out.v[MM + i * C + k] = acc;
      }
    return out;
  }
};

// A Riccati element (d, p, q, a) in Acc, with the flow's sequential step
// and its rank-one fold into a Moebius map (B1's phase A, B3's Riccati
// scan).
template <int M>
struct RicElem {
  static constexpr int MM = M * M;
  Acc d, p[M], q[M], a[MM];

  // Cholesky emission from the state F before this step:
  // c2 = d - p^T F p and u = q - a F p (so w = u / c).
  __device__ __forceinline__ Acc emit(const Acc* F, Acc* u) const {
    Acc Fp[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = F[i * M] * p[0];
#pragma unroll
      for (int j = 1; j < M; ++j) acc += F[i * M + j] * p[j];
      Fp[i] = acc;
    }
    Acc c2 = d;
#pragma unroll
    for (int i = 0; i < M; ++i) c2 -= p[i] * Fp[i];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = q[i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc -= a[i * M + j] * Fp[j];
      u[i] = acc;
    }
    return c2;
  }

  // The sequential Riccati step F <- a F a^T + u u^T / c2.
  __device__ __forceinline__ void advance(Acc* F, const Acc* u, Acc c2) const {
    Acc aF[MM], next[MM];
    mm<Acc, M>(a, F, aF);
    mm_nt<Acc, M>(aF, a, next);
    const Acc inv_c2 = Acc(1) / c2;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) F[i * M + j] = next[i * M + j] + u[i] * u[j] * inv_c2;
  }

  // The element's Riccati map folded after the running value r, by the
  // rank-one step (scan.py:riccati_fold_rank_one):
  // A' = a A - u w^T / c, F' = a F a^T + u u^T / c, G' = G - w w^T / c,
  // with f = F p, c = d - p^T f, u = q - a f and w = A^T p.
  __device__ __forceinline__ void fold(Ric<Acc, M>& r) const {
    Acc* A = r.v;
    Acc* F = r.v + MM;
    Acc* G = r.v + 2 * MM;
    Acc u[M], w[M], aA[MM];
    const Acc c = emit(F, u);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Acc acc = A[j] * p[0];
#pragma unroll
      for (int i = 1; i < M; ++i) acc += A[i * M + j] * p[i];
      w[j] = acc;
    }
    const Acc inv_c = Acc(1) / c;
    mm<Acc, M>(a, A, aA);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        A[i * M + j] = aA[i * M + j] - u[i] * w[j] * inv_c;
        G[i * M + j] -= w[i] * w[j] * inv_c;
      }
    advance(F, u, c);
  }
};

template <class V, typename T>
__device__ __forceinline__ V load(const T* src, long long idx) {
  V x;
#pragma unroll
  for (int c = 0; c < V::S; ++c) x.v[c] = src[idx * V::S + c];
  return x;
}

// ------------------------------------------------------------ cp.async

// Copy one 4- or 8-byte value from device to shared memory asynchronously.
template <typename S>
__device__ __forceinline__ void cp_async_elem(S* dst, const S* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(S) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ----------------------------------- the one-launch look-back (B1, B2, B3)
//
// Kernels B1 and B1r run their two forward scans in one launch at m <= 4
// (quasisep_loglik.cu), B2 its two reverse scans (quasisep_loglik_bwd.cu
// for m <= 4, quasisep_loglik_generic.cu for m = 5..16), and B3 its one
// scan (quasisep_scan.cu for m <= 4, quasisep_generic.cu's one-launch
// scans above; those at m = 5..16 and B2 above 8 fold a group's tiles in
// runs, quasisep_tc.cuh: mono_lookback). Each block takes a tile of consecutive (for a reverse scan mirrored)
// elements by a ticket, so it waits
// only on tiles that running blocks took before it. The tiles form groups of
// kLookGroup. Per scan, a tile publishes its aggregate map (flag 1) for
// the later tiles of its group; the last tile of a group publishes the
// group's aggregate (flag 1) and then the scan's state after the group
// (flag 2). A tile's state at its start is
//
//   start(b) = Q(b)(S(g - 1)),  Q(b) = agg(b - 1) o ... o agg(base),
//   S(g) = GA(g)(S(g - 1)),     GA(g) = Q(base + kLookGroup),  S(-1) = 0,
//
// for tile b of group g whose first tile is base: Q is folded one tile at
// a time from base on, and S(g - 1) is found from the nearest earlier
// group j whose S(j) is published, the groups between having their
// aggregates, by applying those aggregates to S(j) one group at a time, in
// order. Each is the same floating-point operation on the same values
// whichever j a block finds, so the result is bit for bit the fixed
// association above, and two launches on the same inputs agree bit for bit
// (a textbook decoupled look-back composes whatever it finds published
// and rounds differently from run to run). The fold within a group keeps a
// tile's wait short however many tiles run at once: the chain that one
// tile may walk is over groups.
//
// Memory order: a writer stores the value, fences, and then sets the flag
// with release semantics; a reader reads the flag with acquire semantics,
// the warp synchronises and fences, and reads the value through L2
// (ld.cg), since L1 is not coherent between multiprocessors. Every wait
// traps after kWatchdogNs, so a broken protocol fails the launch instead
// of hanging the card. The flags and the ticket are zeroed on the launch's
// stream before it (cudaMemsetAsync in the C entries).

constexpr int kLookGroup = 32;  // tiles a group
constexpr int kTileThreads = 64;  // threads (teams of one) a tile of the m <= 4 kernels

// One scan's published values: per tile its aggregate and flag, per group
// its aggregate, its end state and flag.
struct LookSlots {
  Acc *tile_agg, *group_agg, *group_state;
  unsigned *tile_flag, *group_flag;
};

// The workspace of a one-launch kernel, in Acc: for each of its two scans
// (map and state sizes given) the tiles' and groups' values, then the
// ticket and the flags as 32-bit words.
struct LookLayout {
  long long nt, ng, off[2][3], flags, flag_words, total;
  __host__ __device__ LookLayout(long long nt_, int map0, int state0, int map1, int state1)
      : nt(nt_), ng((nt_ + kLookGroup - 1) / kLookGroup) {
    const int map[2] = {map0, map1}, state[2] = {state0, state1};
    long long at = 0;
    for (int k = 0; k < 2; ++k) {
      off[k][0] = at;
      off[k][1] = at += nt * map[k];
      off[k][2] = at += ng * map[k];
      at += ng * state[k];
    }
    flags = at;
    flag_words = 1 + 2 * (nt + ng);
    total = flags + (flag_words + 1) / 2;
  }
  __device__ unsigned* ticket(Acc* work) const { return reinterpret_cast<unsigned*>(work + flags); }
  __device__ LookSlots slots(Acc* work, int k) const {
    unsigned* f = ticket(work) + 1 + k * (nt + ng);
    return LookSlots{work + off[k][0], work + off[k][1], work + off[k][2], f, f + nt};
  }
};

// The workspace of a one-launch scan with `chains` independent chains of
// tiles (B3: one per group of affine columns) in look-back groups of
// `group` tiles, in Acc: per chain the
// tiles' aggregates, the groups' aggregates and end states; then the
// ticket and each chain's tile and group flags as 32-bit words.
struct ChainLayout {
  long long nt, ng, per, flags, flag_words, total;
  __host__ __device__ ChainLayout(long long nt_, int chains, int map, int state,
                                  int group = kLookGroup)
      : nt(nt_), ng((nt_ + group - 1) / group) {
    per = nt * map + ng * map + ng * state;
    flags = chains * per;
    flag_words = 1 + chains * (nt + ng);
    total = flags + (flag_words + 1) / 2;
  }
  __device__ unsigned* ticket(Acc* work) const { return reinterpret_cast<unsigned*>(work + flags); }
  __device__ LookSlots slots(Acc* work, int k, int map) const {
    Acc* base = work + k * per;
    unsigned* f = ticket(work) + 1 + k * (nt + ng);
    return LookSlots{base, base + nt * map, base + (nt + ng) * map, f, f + nt};
  }
};

constexpr unsigned long long kWatchdogNs = 10000000000ull;
constexpr int kLookWindow = 32;  // flags a warp examines at once

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Wait until *p is nonzero; return it.
__device__ __forceinline__ unsigned wait_nonzero(const unsigned* p) {
  unsigned v = ld_acquire(p);
  if (v) return v;
  const unsigned long long start = global_ns();
  while (!(v = ld_acquire(p))) {
    if (global_ns() - start > kWatchdogNs) __trap();
  }
  return v;
}

// By one warp: the nearest j < b with flag 2 such that every flag in (j, b)
// is nonzero, or -1 (before the first, where every scan starts at 0). Ends
// with the warp's lanes fenced after the flags they saw.
__device__ inline long long lookback_find(long long b, const unsigned* flags) {
  const int lane = threadIdx.x & 31;
  long long j = -1;
  for (long long lo = b; lo > 0; lo -= kLookWindow) {
    const long long i = lo - 1 - lane;
    const unsigned f = i >= 0 ? wait_nonzero(flags + i) : 2u;
    const unsigned two = __ballot_sync(0xffffffffu, f == 2u);
    if (two) {
      j = lo - 1 - (__ffs(two) - 1);
      break;
    }
  }
  __syncwarp();
  __threadfence();
  return j;
}

// By one warp: the published maps [i0, i0 + cnt) of agg (size values each,
// contiguous) into win.
__device__ __forceinline__ void lookback_window(const Acc* agg, long long i0, int cnt, int size,
                                                Acc* win) {
  for (int c = threadIdx.x & 31; c < cnt * size; c += 32) win[c] = __ldcg(agg + i0 * size + c);
  __syncwarp();
}

// The inclusive Kogge-Stone scan of the warp's values x (lane order), by
// shuffles.
template <class V>
__device__ __forceinline__ V warp_inclusive_scan(V x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    V y;
#pragma unroll
    for (int c = 0; c < V::S; ++c) y.v[c] = __shfl_up_sync(0xffffffffu, x.v[c], off);
    if (lane >= off) x = V::combine(y, x);
  }
  return x;
}

// The in-tile scan of the threads' values x (thread order): a Kogge-Stone
// scan in each warp by shuffles, then the second warp's values composed
// after the first warp's total (sm: V::S values). Returns the thread's
// exclusive prefix; the last thread's inclusive value, the tile's
// aggregate, goes to agg (shared memory) and is visible on return.
template <class V>
__device__ V tile_scan(V x, Acc* sm, Acc* agg) {
  static_assert(kTileThreads == 64, "two warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_inclusive_scan<V>(x);
  V ex;
#pragma unroll
  for (int c = 0; c < V::S; ++c) ex.v[c] = __shfl_up_sync(0xffffffffu, x.v[c], 1);
  if (lane == 0) ex = V::identity();
  if (warp == 0 && lane == 31)
    for (int c = 0; c < V::S; ++c) sm[c] = x.v[c];
  __syncthreads();
  if (warp == 1) {
    V tot;
#pragma unroll
    for (int c = 0; c < V::S; ++c) tot.v[c] = sm[c];
    x = V::combine(tot, x);
    ex = lane == 0 ? tot : V::combine(tot, ex);
    if (lane == 31)
      for (int c = 0; c < V::S; ++c) agg[c] = x.v[c];
  }
  __syncthreads();
  return ex;
}

// The affine state s <- A s + B by one thread, s of M x C (row-major);
// map = [A | B].
template <int M, int C = 1>
__device__ __forceinline__ void aff_apply(const Acc* map, Acc* s) {
  Acc t[M * C];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      Acc acc = map[M * M + i * C + k];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += map[i * M + j] * s[j * C + k];
      t[i * C + k] = acc;
    }
#pragma unroll
  for (int c = 0; c < M * C; ++c) s[c] = t[c];
}

// The Riccati state X <- F + A (I + X G)^-1 X A^T by one thread; map =
// [A | F | G].
template <int M>
__device__ __forceinline__ void ric_apply(const Acc* map, Acc* X) {
  constexpr int MM = M * M;
  Acc mat[MM], minv[MM], t1[MM], t2[MM];
  mm<Acc, M>(X, map + 2 * MM, mat);
#pragma unroll
  for (int i = 0; i < M; ++i) mat[i * (M + 1)] += Acc(1);
  inverse<Acc, M>(mat, minv);
  mm<Acc, M>(minv, X, t1);
  mm<Acc, M>(map, t1, t2);
  mm_nt<Acc, M>(t2, map, t1);
#pragma unroll
  for (int c = 0; c < MM; ++c) X[c] = map[MM + c] + t1[c];
}

// One thread publishes `size` values and then sets *flag to v.
__device__ __forceinline__ void publish1(const Acc* src, Acc* dst, int size, unsigned* flag,
                                         unsigned v) {
  for (int c = 0; c < size; ++c) dst[c] = src[c];
  __threadfence();
  st_release(flag, v);
}

// By warp 0, once the tile's aggregate agg (shared memory, a V) is final:
// the scan's state before tile b into st (SZ values of shared memory),
// publishing what later tiles need (the one-launch look-back above). Lane
// 0 applies the maps to the state, in registers.
//
// Q, the composition of the aggregates of the group's tiles before b, is
// folded one tile at a time by lane 0 (kWarpFold false: B2), or by a
// Kogge-Stone scan of those aggregates over the warp's lanes, lane l
// holding tile base + l's, Q being lane b - base - 1's inclusive value
// (kWarpFold true: B1, whose Riccati maps are costly to compose, so that
// the fold takes 5 rounds and not up to 31 steps). Either is one fixed
// association.
template <class V, int SZ, bool kWarpFold = false, class Apply>
__device__ void group_lookback(long long b, long long nt, const LookSlots& sl, const Acc* agg,
                               Acc* win, Acc* st, Apply apply) {
  const int lane = threadIdx.x & 31;
  const long long g = b / kLookGroup, base = g * kLookGroup;
  const bool end = b % kLookGroup == kLookGroup - 1, more = b + 1 < nt;
  if (!end && more && lane == 0) publish1(agg, sl.tile_agg + b * V::S, V::S, sl.tile_flag + b, 1u);
  V Q = V::identity();
  const int cnt = (int)(b - base);
  if (cnt > 0) {
    if (lane < cnt) wait_nonzero(sl.tile_flag + base + lane);
    __syncwarp();
    __threadfence();
    if constexpr (kWarpFold) {
      V x = V::identity();
      if (lane < cnt)
        for (int c = 0; c < V::S; ++c) x.v[c] = __ldcg(sl.tile_agg + (base + lane) * V::S + c);
      x = warp_inclusive_scan<V>(x);
#pragma unroll
      for (int c = 0; c < V::S; ++c) Q.v[c] = __shfl_sync(0xffffffffu, x.v[c], cnt - 1);
    } else {
      lookback_window(sl.tile_agg, base, cnt, V::S, win);
      if (lane == 0)
        for (int l = 0; l < cnt; ++l) Q = V::combine(Q, load<V>(win, l));
      __syncwarp();
    }
  }
  V GA;
  if (end && more && lane == 0) {
    GA = V::combine(Q, load<V>(agg, 0));
    publish1(GA.v, sl.group_agg + g * V::S, V::S, sl.group_flag + g, 1u);
  }
  // S(g - 1): from the nearest group whose end state is published.
  const long long j = lookback_find(g, sl.group_flag);
  Acc s[SZ];
#pragma unroll
  for (int c = 0; c < SZ; ++c) s[c] = j >= 0 ? __ldcg(sl.group_state + j * SZ + c) : Acc(0);
  for (long long i0 = j + 1; i0 < g; i0 += kLookWindow) {
    const int n_win = (int)(g - i0 < kLookWindow ? g - i0 : kLookWindow);
    lookback_window(sl.group_agg, i0, n_win, V::S, win);
    if (lane == 0)
      for (int l = 0; l < n_win; ++l) apply(win + l * V::S, s);
    __syncwarp();
  }
  if (lane == 0) {
    Acc t[SZ];
#pragma unroll
    for (int c = 0; c < SZ; ++c) t[c] = s[c];
    apply(Q.v, t);
#pragma unroll
    for (int c = 0; c < SZ; ++c) st[c] = t[c];
    if (end && more) {
      apply(GA.v, s);
      publish1(s, sl.group_state + g * SZ, SZ, sl.group_flag + g, 2u);
    }
  }
}

// ------------------------------------------- team-cooperative algebra, any m
//
// For quasisep_loglik_generic.cu's b2_warp_kernel. A team is the set of
// threads that shares one monoid value: one warp (WarpTeam). Every thread
// of the team calls each function with the same arguments; the matrices are
// row-major with a leading dimension, in shared or device memory; the
// threads split the output entries, and each function ends with the team's
// barrier so that its result is visible to the whole team.

struct WarpTeam {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// C (r x c) = op(A) op(B) [+ D], where op(A) is r x k and op(B) k x c, and
// op(X) is X or, with the flag set, X^T. C may alias D (each entry of D is
// read only by the thread that writes the same entry of C), not A or B.
// K > 0 is k as a compile-time constant, so that the dot products unroll.
template <int K = 0, class Team>
__device__ inline void gmm(const Team& tm, int r, int k_run, int c, const Acc* A, int lda, bool ta,
                           const Acc* B, int ldb, bool tb, Acc* C, int ldc,
                           const Acc* D = nullptr, int ldd = 0) {
  const int k = K > 0 ? K : k_run;
  for (int idx = tm.rank(); idx < r * c; idx += tm.size()) {
    const int i = idx / c, j = idx - i * c;
    Acc acc = Acc(0);
    for (int l = 0; l < k; ++l) {
      const Acc a = ta ? A[l * lda + i] : A[i * lda + l];
      const Acc b = tb ? B[j * ldb + l] : B[l * ldb + j];
      acc += a * b;
    }
    C[i * ldc + j] = D ? D[i * ldd + j] + acc : acc;
  }
  tm.sync();
}

}  // namespace
