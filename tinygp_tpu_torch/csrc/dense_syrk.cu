// The blocked dense Cholesky's in-place trailing update on Hopper (sm_90a),
// kernel B4, and the 3-term order of the panel product B5, float32.
//
// Replaces, of tinygp_tpu/ops/pallas_dense.py:
//
//   B4  _make_syrk_inplace_kernel (line 158), launched by syrk_sub_inplace
//       (line 201, pallas_call at line 273): in place, T[off:, off:] -= L L^T
//       on the lower tiles of the trailing submatrix, and with `ak` the row
//       side products rowsq[r] = sum_c L[r, c]^2 and rsu[r] = sum_c L[r, c]
//       ak[c] (pallas_dense.py:177-196). Entry: dsk_syrk_inplace.
//   B5  _make_panel_kernel (line 315) at terms = 3 only: out =
//       A[r0:r0+rows, c0:c0+b] @ W with float64 sums. Entry:
//       dsk_panel_matmul_f64. The 2-term order, which the main path runs,
//       and the out-of-place update B6 are in dense_tc.cu, on the tensor
//       cores.
//
// Contract of B4. Every element on or below the diagonal of the trailing
// submatrix is updated exactly once. The strictly upper tiles are never
// touched and hold stale values; within a diagonal tile the elements above
// the diagonal are updated too. The factorization never reads the upper
// triangle (it factors tril of each diagonal block and reads panels below
// the diagonal), so the upper triangle may hold anything.
//
// Accuracy. The TPU kernels reach float32 accuracy through bf16 splits on
// the MXU: 3 terms about 2^-24 per operand, 2 terms about 2^-16. B4
// accumulates every product in float32 FMA whatever `terms` the caller asks
// for, which meets the 3-term contract and so either; the wrapper still
// checks `terms` and `tile`, so the factorization reads like the JAX one.
// The factorization asks for 3 terms below a relative noise floor of 1e-2,
// where B5's product with the explicit inverse inv(L11)^T cancels: with
// float32 sums there, a GP matrix with sqrt(eps) jitter lost more of its
// quadratic form than the native float32 Cholesky does (chip_smoke.py's
// ill-conditioned phase holds the route to it). Float64 sums of the
// float32 products hold it; float32 accumulators cannot, whether in FMA or
// in the tensor cores with float64 sums across 64-wide chunks (PERF.md,
// PRs 4 and 7). So B5's 3-term order stays here, in float64.
//
// What bounds them. At the main path's shapes (N = 1e4 padded to
// m = 10240, block b = 512, trailing sizes 512 j for j = 1..19) one
// factorization's B4 launches do about sum_j 512 (512 j)^2 = 3.3e11 flops:
// 4.9 ms at the 67 TFLOP/s float32 FMA rate, 2.0 ms at the tensor-core rate
// a 3-term bf16 split would allow (989/6 TFLOP/s). They move about 2.6e9
// bytes (0.8 ms at 3.35 TB/s). So B4 is bound by operations, and so is
// B5's float64 order (about 5.1e10 flops of float64 FMA at 34 TFLOP/s).
//
// Design, simple first. A classic shared-memory tiled SGEMM: a block of 256
// threads owns a 128 x 128 output tile, walks the contraction in steps of 8
// through shared memory (tiles padded against bank conflicts) and keeps an
// 8 x 8 micro-tile per thread in registers. Every edge is masked, so any
// rows, b and trailing size work. B4's grid enumerates only the lower tile
// pairs of the trailing submatrix, each block decoding its (i, j) from
// blockIdx.x (there is no scalar prefetch on Hopper); the blocks of the
// first tile column also write the row side products, from L rows a warp
// each, with a fixed reduction order.
//
// Left for later: B4 on dense_tc.cu's tensor-core SYRK body, with the row
// side products in its epilogue (ROADMAP N4d). This design is several
// times its bound (PERF.md has the times).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBM = 128;  // output tile rows
constexpr int kBN = 128;  // output tile columns
constexpr int kBK = 8;    // contraction step
constexpr int kPad = 4;   // shared row padding (keeps float4 alignment)
constexpr int kThreads = 256;
constexpr int kTM = 8;    // micro-tile rows per thread
constexpr int kTN = 8;    // micro-tile columns per thread

using Tile = float[kBK][kBM + kPad];

// acc += A(rows of the tile) @ B(columns of the tile) over K.
// A(i, k) = a[i * lda + k], B(k, j) = b[k * sbk + j * sbj]; a and b point
// at the tile's first row and column; rows_a and cols_b are how many of
// them exist. kNT loads B along k (B4's L^T, sbk = 1), else along j (B5's
// W). Acc is float (float32 FMA) or double (float64 products and sums of
// the float32 operands).
__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(float a, float b, double c) {
  return fma((double)a, (double)b, c);
}

template <bool kNT, typename Acc>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a, long long lda, int rows_a,
                                          const float* __restrict__ b, long long sbk,
                                          long long sbj, int cols_b, int K, Tile& As, Tile& Bs,
                                          Acc (&acc)[kTM][kTN]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < (kBM * kBK) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int i = idx / kBK, kk = idx % kBK;
      const bool ok = i < rows_a && k0 + kk < K;
      As[kk][i] = ok ? a[(long long)i * lda + k0 + kk] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < (kBN * kBK) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int j = kNT ? idx / kBK : idx % kBN, kk = kNT ? idx % kBK : idx / kBN;
      const bool ok = j < cols_b && k0 + kk < K;
      Bs[kk][j] = ok ? b[(long long)(k0 + kk) * sbk + (long long)j * sbj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN + 4]);
      const float ar[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = mad(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The (i, j), j <= i, of lower tile pair g in row-major order.
__device__ __forceinline__ void lower_pair(long long g, int& i, int& j) {
  long long r = (long long)((sqrt(8.0 * (double)g + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > g) --r;
  while ((r + 1) * (r + 2) / 2 <= g) ++r;
  i = (int)r;
  j = (int)(g - r * (r + 1) / 2);
}

// B4: T (m, m) at t, leading dimension ldt, -= L L^T on the lower tile
// pairs (blockIdx.x); L is (m, b) with leading dimension ldl. kExtras: the
// row side products too.
template <bool kExtras>
__global__ void __launch_bounds__(kThreads)
    syrk_kernel(float* t, long long ldt, const float* __restrict__ l, long long ldl, int m, int b,
                const float* __restrict__ ak, float* __restrict__ rowsq,
                float* __restrict__ rsu) {
  __shared__ __align__(16) Tile As;
  __shared__ __align__(16) Tile Bs;
  int bi, bj;
  lower_pair(blockIdx.x, bi, bj);
  const int row0 = bi * kBM, col0 = bj * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  gemm_tile<true>(l + (long long)row0 * ldl, ldl, m - row0, l + (long long)col0 * ldl, 1, ldl,
                  m - col0, b, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c < m) t[(long long)r * ldt + c] -= acc[i][j];
    }
  }

  if (kExtras && bj == 0) {
    // Row side products of this tile row: a warp per row, lanes across
    // the row, then a butterfly sum (a fixed order, so runs repeat).
    const int warp = tid / 32, lane = tid % 32;
    for (int rr = warp; rr < kBM; rr += kThreads / 32) {
      const int r = row0 + rr;
      if (r >= m) break;
      float sq = 0.0f, su = 0.0f;
      for (int c = lane; c < b; c += 32) {
        const float x = l[(long long)r * ldl + c];
        sq = fmaf(x, x, sq);
        su = fmaf(x, ak[c], su);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
        su += __shfl_xor_sync(0xffffffffu, su, o);
      }
      if (lane == 0) {
        rowsq[r] = sq;
        rsu[r] = su;
      }
    }
  }
}

// B5 at 3 terms: out(rows, b) = A(rows, b) @ W(b, b) in float64 sums; a
// points at the panel's first element, read through the row stride lda,
// and W[k, n] is w[k * w_s0 + n * w_s1].
__global__ void __launch_bounds__(kThreads)
    panel_kernel(const float* __restrict__ a, long long lda, const float* __restrict__ w,
                 long long w_s0, long long w_s1, float* __restrict__ out, long long ldo, int rows,
                 int b) {
  __shared__ __align__(16) Tile As;
  __shared__ __align__(16) Tile Bs;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  double acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
  gemm_tile<false>(a + (long long)row0 * lda, lda, rows - row0, w + col0 * w_s1, w_s0, w_s1,
                   b - col0, b, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c < b) out[(long long)r * ldo + c] = (float)acc[i][j];
    }
  }
}

int tiles(int n, int t) { return (n + t - 1) / t; }

}  // namespace

extern "C" {

// B5 at 3 terms: out (rows, b), leading dimension ldo, = A @ W in float64
// sums, with A the (rows, b) panel at a (leading dimension lda) and W
// (b, b) with W[k, n] at w[k * w_s0 + n * w_s1]. Returns a cudaError_t
// code.
int dsk_panel_matmul_f64(const float* a, long long lda, const float* w, long long w_s0,
                         long long w_s1, float* out, long long ldo, int rows, int b,
                         void* stream) {
  if (rows < 0 || b < 0 || lda < b || ldo < b || tiles(rows, kBM) > 65535)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || b == 0) return 0;
  const dim3 grid((unsigned)tiles(b, kBN), (unsigned)tiles(rows, kBM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  panel_kernel<<<grid, kThreads, 0, s>>>(a, lda, w, w_s0, w_s1, out, ldo, rows, b);
  return (int)cudaGetLastError();
}

// B4: in place, t (m, m) -= L L^T on the lower tiles, with t the trailing
// submatrix's first element (leading dimension ldt) and L (m, b) at l
// (leading dimension ldl). With ak (b,) non-null, also rowsq (m,) and
// rsu (m,). Returns a cudaError_t code.
int dsk_syrk_inplace(float* t, long long ldt, const float* l, long long ldl, int m, int b,
                     const float* ak, float* rowsq, float* rsu, void* stream) {
  if (m < 0 || b < 0 || ldt < m || ldl < b || (ak && (!rowsq || !rsu)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const long long mt = tiles(m, kBM);
  const long long pairs = mt * (mt + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ak)
    syrk_kernel<true><<<(unsigned)pairs, kThreads, 0, s>>>(t, ldt, l, ldl, m, b, ak, rowsq, rsu);
  else
    syrk_kernel<false><<<(unsigned)pairs, kThreads, 0, s>>>(t, ldt, l, ldl, m, b, nullptr,
                                                            nullptr, nullptr);
  return (int)cudaGetLastError();
}

const char* dsk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
