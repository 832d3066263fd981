// The generic-order monoid scan engine on Hopper (sm_90a): kernel B3 at
// every order of the quasiseparable algebra, and the scans of B1, B1r and
// B2 above m = 4. Included by quasisep_generic.cu (B3's entries) and
// quasisep_loglik_generic.cu (B1, B1r and B2 for m > 4).
//
// Why not quasisep_scan.cu's kernel at a larger m. There each thread keeps
// one monoid value in registers and a Kogge-Stone pass runs over a shared
// array of every thread's value (quasisep_common.cuh). One Riccati value is
// 3 m^2 doubles: 6 KB at m = 16, so a 64-thread block would need 393 KB of
// shared memory against the 227 KB a block may have, and the values spill
// out of registers long before that.
//
// Design. The order is a run-time argument: m for the affine, congruence
// and Riccati monoids, (m, m2) for the coupling. One block owns one chunk
// of consecutive elements and walks it in sequence; its threads share each
// matrix product, about one output entry per thread (quasisep_common.cuh:
// gmm), with the running value, the element and the scratch in shared
// memory. Three phases, as in the m <= 4 kernels:
//
//   1. g_chunk_pass:  each block folds its chunk into one monoid value
//                     with the full combine (for the Riccati flow, the
//                     Moebius merge through a pivoted inverse of I + F G);
//   2. g_totals_pass: a Hillis-Steele scan of the chunk totals, one launch
//                     per doubling (ceil(log2 nb) launches), each block
//                     merging two totals from device memory;
//   3. g_finish_pass: each block starts from the state its prefix gives
//                     (the leaf of the inclusive total of the chunks
//                     before it; the flow starts at 0) and walks its chunk
//                     with the sequential recurrence, writing the state
//                     before (exclusive) or after (inclusive) each element.
//
// Phase 3 steps the state and does not compose maps: A g + B per affine
// column, A g A^T + B, A g B^T + C, and the Riccati step
// F' = a F a^T + u u^T / c2 (as quasisep_loglik.cu does), so the chunks run
// another algorithm than the merges and agreement with the plain blocked
// scan checks the algorithm and not only the code.
//
// The affine scan's r columns share the transitions; a block takes a group
// of rc columns (grid y), so a value is m^2 + m rc wide. A reverse scan
// mirrors the index, as in quasisep_scan.cu. Every combine and step runs in
// float64 (Acc) whatever the operands' type (see quasisep_loglik.cu,
// Precision); the output is stored in its own type, which may differ from
// the operands' (B1 keeps its Riccati state in float64).
//
// What bounds it: the float64 arithmetic of the merges (about 10 m^3
// multiply-adds and an m x m inverse per element for the Riccati flow) and
// the block barriers between the products. The cost of this design against
// the bound: loads and stores of one element's components are strided
// (component c of element k at [c * n + k]); every product waits on a
// barrier; the chunk pass composes maps where a rank-one element would
// allow a cheaper fold.

#pragma once

#include "quasisep_common.cuh"

namespace {

enum GKind { gAff = 0, gCong = 1, gRic = 2, gCpl = 3 };

constexpr int kGenMaxM = 32;          // largest order the engine takes
constexpr int kGenThreads = 256;      // most threads of a block
constexpr long long kGenMinChunk = 4;
constexpr long long kGenSharedBlock = 232448;  // 227 KB, a block on sm_90
constexpr long long kGenSharedSM = 233472;     // 228 KB per multiprocessor

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

// Scratch of the combine, the element load and the state step, in Acc.
// The Riccati merge needs [M | M^-1] (2 m^2), two products (2 m^2) and the
// inverse's 5 m; its step needs F p, u, 1/c2 and a F (m^2 + 2m + 1).
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
// All block-cooperative: every thread calls them, and each ends with a
// barrier.

// Element k of the scan as a monoid value in v. tmp: 2m + 1 values (the
// Riccati element's p, q and 1/d).
template <typename S>
__device__ void g_element(const GSpec& s, int c, int col0, long long n,
                          const GIn<S>& in, long long k, Acc* v, Acc* tmp) {
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
    case gCpl: {
      const int m2s = s.m2 * s.m2, mc = m * s.m2;
      for (int i = t; i < mm; i += nt) v[i] = Acc(in.x0[i * n + k]);
      for (int i = t; i < m2s; i += nt) v[mm + i] = Acc(in.x1[i * n + k]);
      for (int i = t; i < mc; i += nt) v[mm + m2s + i] = Acc(in.x2[i * n + k]);
      break;
    }
    default: {
      // The Riccati step's Moebius map from (d, p, q, a):
      // A = a - q p^T / d, F = q q^T / d, G = -p p^T / d.
      for (int i = t; i < m; i += nt) {
        tmp[i] = Acc(in.x1[i * n + k]);
        tmp[m + i] = Acc(in.x2[i * n + k]);
      }
      if (t == 0) tmp[2 * m] = Acc(1) / Acc(in.x0[k]);
      __syncthreads();
      const Acc inv_d = tmp[2 * m];
      for (int i = t; i < mm; i += nt) {
        const int a = i / m, b = i - a * m;
        const Acc pa = tmp[a], pb = tmp[b], qa = tmp[m + a], qb = tmp[m + b];
        v[i] = Acc(in.x3[i * n + k]) - qa * pb * inv_d;
        v[mm + i] = qa * qb * inv_d;
        v[2 * mm + i] = -(pa * pb) * inv_d;
      }
    }
  }
  __syncthreads();
}

// out = combine(e, l): the earlier value e, then the later l. out aliases
// neither. scr: g_scratch(s) values; piv: one int.
__device__ void g_combine(const GSpec& s, int c, const Acc* e, const Acc* l,
                          Acc* out, Acc* scr, int* piv) {
  const int m = s.m, mm = m * m;
  switch (s.kind) {
    case gAff:
      // (A_l A_e, A_l B_e + B_l)
      gmm(m, m, m, l, m, false, e, m, false, out, m);
      gmm(m, m, c, l, m, false, e + mm, c, false, out + mm, c, l + mm, c);
      break;
    case gCong:
      // (A_l A_e, A_l B_e A_l^T + B_l)
      gmm(m, m, m, l, m, false, e, m, false, out, m);
      gmm(m, m, m, l, m, false, e + mm, m, false, scr, m);
      gmm(m, m, m, scr, m, false, l, m, true, out + mm, m, l + mm, m);
      break;
    case gCpl: {
      // (A_l A_e, B_l B_e, A_l C_e B_l^T + C_l)
      const int m2 = s.m2, ob = mm, oc = mm + m2 * m2;
      gmm(m, m, m, l, m, false, e, m, false, out, m);
      gmm(m2, m2, m2, l + ob, m2, false, e + ob, m2, false, out + ob, m2);
      gmm(m, m, m2, l, m, false, e + oc, m2, false, scr, m2);
      gmm(m, m2, m2, scr, m2, false, l + ob, m2, true, out + oc, m2, l + oc, m2);
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
      gmm(m, m, m, Fe, m, false, Gl, m, false, W, 2 * m);
      for (int i = threadIdx.x; i < m; i += blockDim.x) W[i * (2 * m) + i] += Acc(1);
      __syncthreads();
      ginverse(m, W, scr + 4 * mm, piv);
      gmm(m, m, m, Minv, 2 * m, false, Ae, m, false, t1, m);
      gmm(m, m, m, Al, m, false, t1, m, false, out, m);
      gmm(m, m, m, Minv, 2 * m, false, Fe, m, false, t1, m);
      gmm(m, m, m, Al, m, false, t1, m, false, t2, m);
      gmm(m, m, m, t2, m, false, Al, m, true, out + mm, m, Fl, m);
      gmm(m, m, m, Minv, 2 * m, true, Gl, m, false, t1, m);
      gmm(m, m, m, Ae, m, true, t1, m, false, t2, m);
      gmm(m, m, m, t2, m, false, Ae, m, false, out + 2 * mm, m, Ge, m);
    }
  }
}

// The state after element k, from the state g before it, into nw. x holds
// the element's operands; t is scratch.
template <typename S>
__device__ void g_step(const GSpec& s, int c, int col0, long long n,
                       const GIn<S>& in, long long k, const Acc* g, Acc* nw,
                       Acc* x, Acc* t) {
  const int m = s.m, mm = m * m;
  switch (s.kind) {
    case gAff:
      // A g + B
      g_element(s, c, col0, n, in, k, x, t);
      gmm(m, m, c, x, m, false, g, c, false, nw, c, x + mm, c);
      break;
    case gCong:
      // A g A^T + B
      g_element(s, c, col0, n, in, k, x, t);
      gmm(m, m, m, x, m, false, g, m, false, t, m);
      gmm(m, m, m, t, m, false, x, m, true, nw, m, x + mm, m);
      break;
    case gCpl: {
      // A g B^T + C
      const int m2 = s.m2, ob = mm, oc = mm + m2 * m2;
      g_element(s, c, col0, n, in, k, x, t);
      gmm(m, m, m2, x, m, false, g, m2, false, t, m2);
      gmm(m, m2, m2, t, m2, false, x + ob, m2, true, nw, m2, x + oc, m2);
      break;
    }
    default: {
      // F' = a F a^T + u u^T / c2 with Fp = F p, c2 = d - p^T Fp and
      // u = q - a Fp (quasisep_loglik.cu: Elem::emit, Elem::advance).
      Acc* a = x;
      Acc* p = x + mm;
      Acc* q = p + m;
      const int tid = threadIdx.x, nt = blockDim.x;
      for (int i = tid; i < mm; i += nt) a[i] = Acc(in.x3[i * n + k]);
      for (int i = tid; i < m; i += nt) {
        p[i] = Acc(in.x1[i * n + k]);
        q[i] = Acc(in.x2[i * n + k]);
      }
      if (tid == 0) q[m] = Acc(in.x0[k]);
      __syncthreads();
      Acc* Fp = t;
      Acc* u = t + m;
      Acc* aF = t + 2 * m + 1;
      gmm(m, m, 1, g, m, false, p, 1, false, Fp, 1);
      for (int i = tid; i < m; i += nt) {
        Acc acc = q[i];
        for (int j = 0; j < m; ++j) acc -= a[i * m + j] * Fp[j];
        u[i] = acc;
      }
      if (tid == 0) {
        Acc c2 = q[m];
        for (int i = 0; i < m; ++i) c2 -= p[i] * Fp[i];
        t[2 * m] = Acc(1) / c2;
      }
      gmm(m, m, m, a, m, false, g, m, false, aF, m);
      const Acc inv_c2 = t[2 * m];
      for (int idx = tid; idx < mm; idx += nt) {
        const int i = idx / m, j = idx - i * m;
        Acc acc = Acc(0);
        for (int l = 0; l < m; ++l) acc += aF[i * m + l] * a[j * m + l];
        nw[idx] = acc + u[i] * u[j] * inv_c2;
      }
      __syncthreads();
    }
  }
}

// Write the state g as element k's output (no barrier: g is only read).
template <typename O>
__device__ void g_store(const GSpec& s, int c, int col0, long long n, O* out,
                        long long k, const Acc* g) {
  const int t = threadIdx.x, nt = blockDim.x;
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

// ------------------------------------------------------------------ kernels

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
  g_element(s, c, col0, n, in, g_element_index(lo, n, reverse), acc, scr);
  for (long long pos = lo + 1; pos < hi; ++pos) {
    g_element(s, c, col0, n, in, g_element_index(pos, n, reverse), x, scr);
    g_combine(s, c, acc, x, o, scr, piv);
    Acc* swap = acc;
    acc = o;
    o = swap;
  }
  Acc* dst = tot + ((long long)group * gridDim.x + blockIdx.x) * size;
  for (int i = threadIdx.x; i < g_size(s, c); i += blockDim.x) dst[i] = acc[i];
}

// One Hillis-Steele step over the chunk totals: out[b] = in[b - off] . in[b].
__global__ void __launch_bounds__(kGenThreads)
g_totals_pass(GSpec s, long long off, const Acc* in, Acc* out) {
  Acc* scr = reinterpret_cast<Acc*>(qsl_smem);
  int* piv = reinterpret_cast<int*>(scr + g_scratch(s));
  const int size = g_size(s, s.rc), c = g_cols(s, blockIdx.y);
  const long long at = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * size;
  if ((long long)blockIdx.x < off) {
    for (int i = threadIdx.x; i < g_size(s, c); i += blockDim.x) out[at + i] = in[at + i];
    return;
  }
  g_combine(s, c, in + at - off * size, in + at, out + at, scr, piv);
}

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
    // The flow starts at 0, so the state at the chunk's start is the leaf
    // of the inclusive total of the chunks before it.
    const Acc* src = incl + ((long long)group * gridDim.x + blockIdx.x - 1) * size + g_leaf(s);
    for (int i = threadIdx.x; i < state; i += blockDim.x) g[i] = src[i];
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  for (long long pos = lo; pos < hi; ++pos) {
    const long long k = g_element_index(pos, n, reverse);
    if (!inclusive) g_store(s, c, col0, n, out, k, g);
    g_step(s, c, col0, n, in, k, g, nw, x, t);
    Acc* swap = g;
    g = nw;
    nw = swap;
    if (inclusive) g_store(s, c, col0, n, out, k, g);
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
  int threads, groups, size;
  long long smem, chunk, nb;
};

inline int g_sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Threads, shared memory and chunks: enough chunks for one wave of blocks
// on every multiprocessor, each chunk at least kGenMinChunk elements.
inline GPlan g_plan(const GSpec& s, long long n) {
  GPlan p;
  p.groups = (s.r + s.rc - 1) / s.rc;
  p.size = g_size(s, s.rc);
  const int m = s.m, m2 = s.m2;
  int work = m * m;
  if (s.kind == gAff && m * s.rc > work) work = m * s.rc;
  if (s.kind == gRic) work = 2 * m * m;  // the inverse's row updates
  if (s.kind == gCpl) {
    if (m2 * m2 > work) work = m2 * m2;
    if (m * m2 > work) work = m * m2;
  }
  int threads = (work + 31) / 32 * 32;
  p.threads = threads > kGenThreads ? kGenThreads : threads;
  p.smem = (3LL * p.size + g_scratch(s)) * (long long)sizeof(Acc) + 16;
  long long per_sm = 2048 / p.threads;
  if (per_sm > 32) per_sm = 32;
  const long long by_smem = kGenSharedSM / (p.smem + 1024);
  if (by_smem < per_sm) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  long long target = g_sm_count() * per_sm / p.groups;
  if (target < 1) target = 1;
  p.chunk = (n + target - 1) / target;
  if (p.chunk < kGenMinChunk) p.chunk = kGenMinChunk;
  p.nb = (n + p.chunk - 1) / p.chunk;
  return p;
}

// Workspace of one scan, in Acc: two buffers of chunk totals.
inline long long g_workspace_elems(const GSpec& s, long long n) {
  const GPlan p = g_plan(s, n);
  return 2LL * p.groups * p.nb * p.size;
}

// One scan into out (the state before or after each element), on stream st,
// with a workspace of g_workspace_elems(s, n) values.
template <typename S, typename O>
cudaError_t g_run(const GSpec& s, long long n, int reverse, int inclusive,
                  const GIn<S>& in, O* out, Acc* work, cudaStream_t st) {
  const GPlan p = g_plan(s, n);
  if (p.smem > kGenSharedBlock || p.nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  Acc* cur = work;
  Acc* other = work + (long long)p.groups * p.nb * p.size;
  const dim3 grid((unsigned)p.nb, (unsigned)p.groups);
  const long long totals_smem = g_scratch(s) * (long long)sizeof(Acc) + 16;
  cudaError_t e = g_launch(g_chunk_pass<S>, grid, p.threads, p.smem, st, s, n,
                           p.chunk, reverse, in, cur);
  for (long long off = 1; e == cudaSuccess && off < p.nb; off <<= 1) {
    e = g_launch(g_totals_pass, grid, p.threads, totals_smem, st, s, off,
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
