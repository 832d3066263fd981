// Shared pieces of the quasiseparable log-likelihood kernels on Hopper
// (sm_90a): the m x m algebra with closed-form inverses, the Riccati and
// affine monoids, the in-block Kogge-Stone scan and the single-block scan
// of block totals. Included by quasisep_loglik.cu (kernels B1 and B1r),
// quasisep_loglik_bwd.cu (kernel B2) and quasisep_scan.cu (kernel B3).
// Its last section, the block-cooperative algebra at any order with a
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

// ------------------------------------------- block-cooperative algebra, any m
//
// For the generic-order engine (quasisep_generic.cuh). Every thread of the
// block calls each function with the same arguments; the matrices are
// row-major with a leading dimension, in shared or device memory; the
// threads split the output entries, and each function ends with
// __syncthreads() so that its result is visible to the whole block.

// C (r x c) = op(A) op(B) [+ D], where op(A) is r x k and op(B) k x c, and
// op(X) is X or, with the flag set, X^T. C may alias D (each entry of D is
// read only by the thread that writes the same entry of C), not A or B.
__device__ inline void gmm(int r, int k, int c, const Acc* A, int lda, bool ta,
                           const Acc* B, int ldb, bool tb, Acc* C, int ldc,
                           const Acc* D = nullptr, int ldd = 0) {
  for (int idx = threadIdx.x; idx < r * c; idx += blockDim.x) {
    const int i = idx / c, j = idx - i * c;
    Acc acc = Acc(0);
    for (int l = 0; l < k; ++l) {
      const Acc a = ta ? A[l * lda + i] : A[i * lda + l];
      const Acc b = tb ? B[j * ldb + l] : B[l * ldb + j];
      acc += a * b;
    }
    C[i * ldc + j] = D ? D[i * ldd + j] + acc : acc;
  }
  __syncthreads();
}

// Gauss-Jordan inverse with partial pivoting. W is m x 2m (row stride 2m)
// with the matrix in its left half; on return the right half holds the
// inverse. scr holds 5m values (the pivot row, the displaced row and the
// column's factors) and piv one int. At the orders of the generic engine
// (up to 32) the scan merges' I + F G is not reliably near the identity,
// so unlike the closed forms above this pivots.
__device__ inline void ginverse(int m, Acc* W, Acc* scr, int* piv) {
  const int ld = 2 * m;
  for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    W[i * ld + m + j] = i == j ? Acc(1) : Acc(0);
  }
  __syncthreads();
  Acc* prow = scr;          // the pivot row, scaled
  Acc* orow = scr + ld;     // row col before the swap
  Acc* fac = scr + 2 * ld;  // each row's entry in column col
  for (int col = 0; col < m; ++col) {
    if (threadIdx.x == 0) {
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
    __syncthreads();
    const int p = *piv;
    const Acc inv_pivot = Acc(1) / W[p * ld + col];
    for (int j = threadIdx.x; j < ld; j += blockDim.x) {
      prow[j] = W[p * ld + j] * inv_pivot;
      orow[j] = W[col * ld + j];
    }
    // Row p takes the old row col, whose entry in this column is W[col][col].
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      fac[i] = i == p ? W[col * ld + col] : W[i * ld + col];
    __syncthreads();
    for (int idx = threadIdx.x; idx < m * ld; idx += blockDim.x) {
      const int i = idx / ld, j = idx - i * ld;
      if (i == col)
        W[idx] = prow[j];
      else if (i == p)
        W[idx] = orow[j] - fac[i] * prow[j];
      else
        W[idx] -= fac[i] * prow[j];
    }
    __syncthreads();
  }
}

}  // namespace
