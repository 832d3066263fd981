// Shared pieces of the quasiseparable log-likelihood kernels on Hopper
// (sm_90a): the m x m algebra with closed-form inverses, the Riccati and
// affine monoids, the in-block Kogge-Stone scan and the single-block scan
// of block totals (kernels B1 and B1r in quasisep_loglik.cu, B3 in
// quasisep_scan.cu); cp.async and the one-launch look-back of kernel B2
// (quasisep_loglik_bwd.cu, and quasisep_loglik_generic.cu at m = 5..8).
// Its last section, the team-cooperative algebra at any order with a
// pivoted inverse, serves the generic-order engine (quasisep_generic.cuh).

#pragma once

#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char qsl_smem[];

namespace {

constexpr int kThreads = 64;  // threads per block of the chunk passes
constexpr int kChunk = 8;     // consecutive elements per thread
constexpr int kScanThreads = 256;
constexpr int kSharedLimit = 48 * 1024;

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

// The affine recurrence g' = A g + B, flattened [A | B].
template <typename T, int M>
struct Aff {
  static constexpr int MM = M * M;
  static constexpr int S = MM + M;
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
    for (int i = 0; i < M; ++i) {
      T acc = l.v[MM + i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += l.v[i * M + j] * e.v[MM + j];
      out.v[MM + i] = acc;
    }
    return out;
  }
};

template <class V, typename T>
__device__ __forceinline__ V load(const T* src, long long idx) {
  V x;
#pragma unroll
  for (int c = 0; c < V::S; ++c) x.v[c] = src[idx * V::S + c];
  return x;
}

template <class V, typename T>
__device__ __forceinline__ void store(T* dst, long long idx, const V& x) {
#pragma unroll
  for (int c = 0; c < V::S; ++c) dst[idx * V::S + c] = x.v[c];
}

// Shared memory holds one value per thread and component, component-major
// (sm[c * nt + t]) so that neighbouring threads hit neighbouring banks.
template <class V, typename T>
__device__ __forceinline__ V sm_load(const T* sm, int t, int nt) {
  V x;
#pragma unroll
  for (int c = 0; c < V::S; ++c) x.v[c] = sm[c * nt + t];
  return x;
}

template <class V, typename T>
__device__ __forceinline__ void sm_store(T* sm, int t, int nt, const V& x) {
#pragma unroll
  for (int c = 0; c < V::S; ++c) sm[c * nt + t] = x.v[c];
}

// Kogge-Stone inclusive scan over the block's threads. On return the
// shared array holds every thread's inclusive value.
template <class V, typename T>
__device__ V block_inclusive_scan(V x, T* sm) {
  const int t = threadIdx.x, nt = blockDim.x;
  sm_store<V>(sm, t, nt, x);
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    V y = x;
    if (t >= off) y = V::combine(sm_load<V>(sm, t - off, nt), x);
    __syncthreads();
    if (t >= off) {
      x = y;
      sm_store<V>(sm, t, nt, x);
    }
    __syncthreads();
  }
  return x;
}

template <class V, typename T>
__device__ __forceinline__ V block_exclusive(const T* sm) {
  const int t = threadIdx.x;
  return t == 0 ? V::identity() : sm_load<V>(sm, t - 1, blockDim.x);
}

// Exclusive scan of `nb` block totals, in place, by one block. With a grid
// of several blocks along y, block y scans the y-th run of nb totals.
template <class V, typename T>
__global__ void scan_totals(int nb, T* tot) {
  T* sm = reinterpret_cast<T*>(qsl_smem);
  tot += (long long)blockIdx.y * nb * V::S;
  const int t = threadIdx.x, nt = blockDim.x;
  const int per = (nb + nt - 1) / nt;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  V acc = V::identity();
  for (int i = lo; i < hi; ++i) acc = V::combine(acc, load<V>(tot, i));
  block_inclusive_scan<V>(acc, sm);
  V pre = block_exclusive<V>(sm);
  for (int i = lo; i < hi; ++i) {
    const V x = load<V>(tot, i);
    store(tot, i, pre);
    pre = V::combine(pre, x);
  }
}

long long num_blocks(long long n) {
  return (n + (long long)kThreads * kChunk - 1) / ((long long)kThreads * kChunk);
}

// Threads of a single-block scan: as many as fit the default shared limit.
template <class V, typename T>
int scan_threads() {
  int nt = kScanThreads;
  while (nt > 32 && (long long)nt * V::S * sizeof(T) > kSharedLimit) nt /= 2;
  return nt;
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

// ------------------------------------------ the one-launch look-back (B2)
//
// Kernel B2 runs its two reverse scans in one launch (quasisep_loglik_bwd.cu
// for m <= 4, quasisep_loglik_generic.cu for m = 5..8). Each block takes a
// tile of consecutive (mirrored) elements by a ticket, so it waits only on
// tiles that running blocks took before it. The tiles form groups of
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

// One scan's published values: per tile its aggregate and flag, per group
// its aggregate, its end state and flag.
struct LookSlots {
  Acc *tile_agg, *group_agg, *group_state;
  unsigned *tile_flag, *group_flag;
};

// The workspace of B2's one launch, in Acc: for each of its two scans
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

// ------------------------------------------- team-cooperative algebra, any m
//
// For the generic-order engine (quasisep_generic.cuh). A team is the set of
// threads that shares one monoid value: a whole block (BlockTeam) or one
// warp of it (WarpTeam, for values small enough that a warp's products
// need no block barrier). Every thread of the team calls each function
// with the same arguments; the matrices are row-major with a leading
// dimension, in shared or device memory; the threads split the output
// entries, and each function ends with the team's barrier so that its
// result is visible to the whole team.

struct BlockTeam {
  static constexpr bool kWarp = false;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

struct WarpTeam {
  static constexpr bool kWarp = true;
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

// Gauss-Jordan inverse with partial pivoting. W is m x 2m (row stride 2m)
// with the matrix in its left half; on return the right half holds the
// inverse. scr holds 5m values (the pivot row, the displaced row and the
// column's factors) and piv one int. At the orders of the generic engine
// (up to 32) the scan merges' I + F G is not reliably near the identity,
// so unlike the closed forms above this pivots.
template <class Team>
__device__ inline void ginverse(const Team& tm, int m, Acc* W, Acc* scr, int* piv) {
  const int ld = 2 * m, t = tm.rank(), nt = tm.size();
  for (int idx = t; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx - i * m;
    W[i * ld + m + j] = i == j ? Acc(1) : Acc(0);
  }
  tm.sync();
  Acc* prow = scr;          // the pivot row, scaled
  Acc* orow = scr + ld;     // row col before the swap
  Acc* fac = scr + 2 * ld;  // each row's entry in column col
  for (int col = 0; col < m; ++col) {
    if (t == 0) {
      int p = col;
      Acc best = fabs(W[col * ld + col]);
      for (int i = col + 1; i < m; ++i) {
        const Acc v = fabs(W[i * ld + col]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      *piv = p;
    }
    tm.sync();
    const int p = *piv;
    const Acc inv_pivot = Acc(1) / W[p * ld + col];
    for (int j = t; j < ld; j += nt) {
      prow[j] = W[p * ld + j] * inv_pivot;
      orow[j] = W[col * ld + j];
    }
    // Row p takes the old row col, whose entry in this column is W[col][col].
    for (int i = t; i < m; i += nt)
      fac[i] = i == p ? W[col * ld + col] : W[i * ld + col];
    tm.sync();
    for (int idx = t; idx < m * ld; idx += nt) {
      const int i = idx / ld, j = idx - i * ld;
      if (i == col)
        W[idx] = prow[j];
      else if (i == p)
        W[idx] = orow[j] - fac[i] * prow[j];
      else
        W[idx] -= fac[i] * prow[j];
    }
    tm.sync();
  }
}

}  // namespace
