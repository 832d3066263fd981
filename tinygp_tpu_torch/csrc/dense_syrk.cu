// The 3-term order of the blocked dense Cholesky's panel product B5 on
// Hopper (sm_90a), float32 in and out, float64 sums.
//
// Replaces, of tinygp_tpu/ops/pallas_dense.py:
//
//   B5  _make_panel_kernel (line 315) at terms = 3 only: out =
//       A[r0:r0+rows, c0:c0+b] @ W with float64 sums. Entry:
//       dsk_panel_matmul_f64. The 2-term order, which the main path runs,
//       the in-place trailing update B4 and the out-of-place update B6 are
//       in dense_tc.cu, on the tensor cores.
//
// Accuracy. The TPU kernels reach float32 accuracy through bf16 splits on
// the MXU: 3 terms about 2^-24 per operand, 2 terms about 2^-16. The
// factorization asks for 3 terms below a relative noise floor of 1e-2,
// where B5's product with the explicit inverse inv(L11)^T cancels: with
// float32 sums there, a GP matrix with sqrt(eps) jitter lost more of its
// quadratic form than the native float32 Cholesky does (chip_smoke.py's
// ill-conditioned phase holds the route to it). Float64 sums of the
// float32 products hold it; float32 accumulators cannot, whether in FMA or
// in the tensor cores with float64 sums across 64-wide chunks (PERF.md,
// PRs 4 and 7). So B5's 3-term order stays here, in float64.
//
// What bounds it. At the main path's shapes (N = 1e4 padded to
// m = 10240, block b = 512, panels of 512 j rows for j = 1..19) one
// factorization's panels do 2 rows b^2 = 5.1e10 flops of float64 FMA:
// 0.76 ms at the float64 tensor-core rate of 67 TFLOP/s, 1.5 ms at the
// 34 TFLOP/s of the float64 FMA units this body uses, against about
// 0.12 ms for its bytes. So it is bound by operations.
//
// Design, simple first. A classic shared-memory tiled GEMM: a block of 256
// threads owns a 128 x 128 output tile, walks the contraction in steps of 8
// through shared memory (tiles padded against bank conflicts) and keeps an
// 8 x 8 micro-tile of float64 sums per thread in registers. Every edge is
// masked, so any rows and b work.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // output tile rows
constexpr int kBN = 128;  // output tile columns
constexpr int kBK = 8;    // contraction step
constexpr int kPad = 4;   // shared row padding (keeps float4 alignment)
constexpr int kThreads = 256;
constexpr int kTM = 8;    // micro-tile rows per thread
constexpr int kTN = 8;    // micro-tile columns per thread

using Tile = float[kBK][kBM + kPad];

// acc += A(rows of the tile) @ B(columns of the tile) over K, float64
// products and sums of the float32 operands. A(i, k) = a[i * lda + k],
// B(k, j) = b[k * sbk + j * sbj]; a and b point at the tile's first row
// and column; rows_a and cols_b are how many of them exist.
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a, long long lda, int rows_a,
                                          const float* __restrict__ b, long long sbk,
                                          long long sbj, int cols_b, int K, Tile& As, Tile& Bs,
                                          double (&acc)[kTM][kTN]) {
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
      const int j = idx % kBN, kk = idx / kBN;
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
        for (int j = 0; j < kTN; ++j) acc[i][j] = fma((double)ar[i], (double)br[j], acc[i][j]);
    }
    __syncthreads();
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
  gemm_tile(a + (long long)row0 * lda, lda, rows - row0, w + col0 * w_s1, w_s0, w_s1, b - col0, b,
            As, Bs, acc);
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

const char* dsk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
