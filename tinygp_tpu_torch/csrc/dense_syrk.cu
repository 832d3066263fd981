// The 3-term order of the blocked dense Cholesky's panel product B5 on
// Hopper's float64 tensor cores (sm_90a), float32 in and out, float64 sums.
//
// Replaces, of tinygp_tpu/ops/pallas_dense.py:
//
//   B5  _make_panel_kernel (line 315) at terms = 3 only: out =
//       A[r0:r0+rows, c0:c0+b] @ W with float64 sums. Entry:
//       dsk_panel_matmul_f64. The 2-term order, which the main path runs,
//       the in-place trailing update B4 and the out-of-place update B6 are
//       in dense_tc.cu, on the bf16 tensor cores.
//
// Accuracy. The TPU kernels reach float32 accuracy through bf16 splits on
// the MXU: 3 terms about 2^-24 per operand, 2 terms about 2^-16. The
// factorization asks for 3 terms below a relative noise floor of 1e-2,
// where B5's product with the explicit inverse inv(L11)^T cancels: with
// float32 sums there, a GP matrix with sqrt(eps) jitter lost more of its
// quadratic form than the native float32 Cholesky does (chip_smoke.py's
// ill-conditioned phase holds the route to it). Float64 sums of the
// float32 products hold it; float32 accumulators cannot, whether in FMA or
// in the bf16 tensor cores with float64 sums across 64-wide chunks
// (PERF.md, Findings). The float64 tensor cores (DMMA) compute exactly
// this: a float32 value is exact in float64 and the product of two is
// exact in float64 (48 of 53 bits), so every product is exact and every
// sum is a float64 sum; only the order of summation differs from a
// sequential loop. Order: within a split (below) the contraction runs in
// steps of kBK, each in mma steps of kMmaK in order; the splits' partial
// sums are then added in rank order. cuda_dense.plain_panel_matmul_f64
// repeats that order in plain PyTorch.
//
// What bounds it. At the main path's shapes (N = 1e4 padded to
// m = 10240, block b = 512, panels of 512 j rows for j = 1..19) one
// factorization's panels do 2 rows b^2 = 5.1e10 flops: 0.76 ms at the
// float64 tensor-core rate of 67 TFLOP/s, against about 0.12 ms for their
// bytes. So it is bound by operations.
//
// Design.
//   - Tiles: a block of 256 threads (8 warps, 2 x 4) owns a 128 x 128
//     output tile; each warp a 64 x 32 sub-tile of 4 x 4 mma tiles of
//     16 x 8 (mma.sync m16n8k{kMmaK}.f64), 64 float64 sums per thread.
//   - Staging: the panel tile (128 rows x kBK) and W's (kBK x 128
//     columns) stay float32 in shared memory, kStages deep, loaded by
//     cp.async (16 bytes along whichever axis of W is contiguous, else 4)
//     with zero fill past every edge, so any rows and b work. Rows are
//     padded (kLd = kBK + 4, kLdN = kBN + 8 floats), so a warp's fragment
//     loads hit 32 banks.
//     Fragments are converted to float64 as they are read: the staging
//     moves half the bytes of float64, and a 64 x 32 warp tile converts
//     one value per 21 multiply-adds.
//   - W is read through both strides: the factorization passes
//     inv(L11)^T as a view, whose k axis is contiguous, staged as W^T
//     (Bs[n][k]); a contiguous W is staged as it lies (Bs[k][n]).
//   - Filling the SMs: a small panel (16 tiles at 512 rows) splits the
//     contraction over S = 2, 4 or 8 blocks of one thread block cluster
//     (grid z), until about kSplitTarget blocks run. Each block leaves its
//     float64 partial tile in its shared memory; after a cluster barrier,
//     block z sums rows z 128/S .. (z+1) 128/S of every partial through
//     distributed shared memory in rank order and stores them, so the
//     result is the same from run to run. S depends only on rows and b
//     (panel_splits), never on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 128;        // output tile rows
constexpr int kBN = 128;        // output tile columns
constexpr int kBK = 32;         // contraction step staged per stage
constexpr int kLd = kBK + 4;    // padded shared row (floats): 32 banks per fragment load
constexpr int kLdN = kBN + 8;   // the same for W staged by rows of k
constexpr int kStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;  // warp tile rows
constexpr int kWN = kBN / kWarpsN;  // warp tile columns
constexpr int kMT = kWM / 16;   // mma tiles per warp, rows
constexpr int kNT = kWN / 8;    // mma tiles per warp, columns
constexpr int kMmaK = 8;          // the mma's depth: 4, 8 or 16 (no faster, PERF.md)
constexpr int kMaxSplit = 8;      // the largest portable cluster
constexpr int kSplitTarget = 132; // blocks a split aims for (one H100 wave)
constexpr int kPLd = kBN + 2;     // the partial tile's row, in doubles

constexpr int kStageFloats = 2 * kBM * kLd;  // panel and W^T tiles
constexpr int kStagingBytes = kStages * kStageFloats * 4;
constexpr int kPartialBytes = kBM * kPLd * 8;
constexpr int kSmemBytes = kStagingBytes > kPartialBytes ? kStagingBytes : kPartialBytes;

static_assert(kMmaK == 4 || kMmaK == 8 || kMmaK == 16, "mma depth");
static_assert(kBK % kMmaK == 0, "kBK is a whole number of mma steps");
static_assert(kBK * kLdN <= kBN * kLd, "W staged by rows of k fits its slot");

// How W's stage is loaded: 4 bytes at a time, or 16 along k (W^T's rows,
// Bs[n][k]) or along n (W's rows, Bs[k][n]).
enum WLoad { kWScalar = 0, kWAlongK = 1, kWAlongN = 2 };

// D += A B for one 16 x 8 x kMmaK tile, float64. Fragments (lane = 4 g + t):
// a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)], b[i] = B[t + 4 i][g],
// c[i] = D[g + 8 (i >> 1)][2 t + (i & 1)].
__device__ __forceinline__ void mma(double (&c)[4], const double* a, const double* b) {
  if constexpr (kMmaK == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
        "{%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (kMmaK == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 4) from src to shared dst, zero-filled where !ok.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const int n = ok ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

struct Panel {
  const float* a;  // the panel's first element
  long long lda;
  const float* w;  // W[k, n] = w[k * w_s0 + n * w_s1]
  long long w_s0, w_s1;
  float* out;
  long long ldo;
  int rows, b;
};

// Stage k-chunk [k0, k0 + kBK) of the block's panel rows (As[i][k]) and of
// W's columns (Bs[n][k], or Bs[k][n] for kWAlongN); every element outside
// the panel or W is zero. kVecA: the rows of A load 16 bytes at a time.
template <bool kVecA, int kW>
__device__ __forceinline__ void load_stage(const Panel& p, int row0, int col0, int k0, int k1,
                                           float* As, float* Bs) {
  const int tid = threadIdx.x;
  if constexpr (kVecA) {
#pragma unroll
    for (int e = 0; e < kBM * kBK / 4 / kThreads; ++e) {
      const int idx = tid + e * kThreads, i = idx / (kBK / 4), kk = (idx % (kBK / 4)) * 4;
      const bool ok = row0 + i < p.rows && k0 + kk < k1;
      const float* src = ok ? p.a + (long long)(row0 + i) * p.lda + k0 + kk : p.a;
      cp_async<16>(As + i * kLd + kk, src, ok);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < kBM * kBK / kThreads; ++e) {
      const int idx = tid + e * kThreads, i = idx / kBK, kk = idx % kBK;
      const bool ok = row0 + i < p.rows && k0 + kk < k1;
      const float* src = ok ? p.a + (long long)(row0 + i) * p.lda + k0 + kk : p.a;
      cp_async<4>(As + i * kLd + kk, src, ok);
    }
  }
  if constexpr (kW == kWAlongK) {
#pragma unroll
    for (int e = 0; e < kBN * kBK / 4 / kThreads; ++e) {
      const int idx = tid + e * kThreads, n = idx / (kBK / 4), kk = (idx % (kBK / 4)) * 4;
      const bool ok = col0 + n < p.b && k0 + kk < k1;
      const float* src = ok ? p.w + (long long)(k0 + kk) + (long long)(col0 + n) * p.w_s1 : p.w;
      cp_async<16>(Bs + n * kLd + kk, src, ok);
    }
  } else if constexpr (kW == kWAlongN) {
#pragma unroll
    for (int e = 0; e < kBN * kBK / 4 / kThreads; ++e) {
      const int idx = tid + e * kThreads, kk = idx / (kBN / 4), n = (idx % (kBN / 4)) * 4;
      const bool ok = col0 + n < p.b && k0 + kk < k1;
      const float* src = ok ? p.w + (long long)(k0 + kk) * p.w_s0 + (col0 + n) : p.w;
      cp_async<16>(Bs + kk * kLdN + n, src, ok);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < kBN * kBK / kThreads; ++e) {
      const int idx = tid + e * kThreads, n = idx / kBK, kk = idx % kBK;
      const bool ok = col0 + n < p.b && k0 + kk < k1;
      const float* src =
          ok ? p.w + (long long)(k0 + kk) * p.w_s0 + (long long)(col0 + n) * p.w_s1 : p.w;
      cp_async<4>(Bs + n * kLd + kk, src, ok);
    }
  }
}

// B5 at 3 terms: out(rows, b) = A(rows, b) @ W(b, b) in float64 sums, one
// 128 x 128 tile per (blockIdx.x, blockIdx.y) and the contraction split
// over gridDim.z blocks of one cluster, each taking kper values of k.
template <bool kVecA, int kW>
__global__ void __launch_bounds__(kThreads, 1) panel_kernel(Panel p, int kper) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int k_lo = split * kper;
  const int k_hi = k_lo + kper < p.b ? k_lo + kper : p.b;
  const int nk = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;

  double acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<kVecA, kW>(p, row0, col0, k_lo + s * kBK, k_hi, stage + s * kStageFloats,
                            stage + s * kStageFloats + kBM * kLd);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // The stage read at kt - 1 is free once every thread is past the barrier.
    const int next = kt + kStages - 1;
    if (next < nk) {
      float* s = stage + (next % kStages) * kStageFloats;
      load_stage<kVecA, kW>(p, row0, col0, k_lo + next * kBK, k_hi, s, s + kBM * kLd);
    }
    cp_async_commit();
    const float* As = stage + (kt % kStages) * kStageFloats + wm * kLd;
    const float* Bs =
        stage + (kt % kStages) * kStageFloats + kBM * kLd + (kW == kWAlongN ? wn : wn * kLd);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += kMmaK) {
      double bf[kNT][kMmaK / 4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < kMmaK / 4; ++i)
          bf[j][i] = (double)(kW == kWAlongN ? Bs[(ks + t + 4 * i) * kLdN + j * 8 + g]
                                             : Bs[(j * 8 + g) * kLd + ks + t + 4 * i]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        double af[kMmaK / 2];
#pragma unroll
        for (int i = 0; i < kMmaK / 2; ++i)
          af[i] = (double)As[(mt * 16 + g + 8 * (i & 1)) * kLd + ks + t + 4 * (i >> 1)];
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(acc[mt][j], af, bf[j]);
      }
    }
  }
  cp_async_wait<0>();

  if (nsplit == 1) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row0 + wm + mt * 16 + g + 8 * (r >> 1);
          const int col = col0 + wn + j * 8 + 2 * t + (r & 1);
          if (row < p.rows && col < p.b) p.out[(long long)row * p.ldo + col] = (float)acc[mt][j][r];
        }
    return;
  }

  // Split contraction: leave the partial tile in shared memory, then sum
  // this block's share of rows over the cluster's partials in rank order.
  __syncthreads();  // every warp is done with the staging this aliases
  double* part = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + mt * 16 + g + 8 * h, col = wn + j * 8 + 2 * t;
        *reinterpret_cast<double2*>(part + row * kPLd + col) =
            make_double2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = kBM / nsplit;
  for (int idx = threadIdx.x; idx < share * kBN; idx += kThreads) {
    const int r = split * share + idx / kBN, c = idx % kBN;
    double sum = 0.0;
    for (int q = 0; q < nsplit; ++q) sum += cluster.map_shared_rank(part, q)[r * kPLd + c];
    const int row = row0 + r, col = col0 + c;
    if (row < p.rows && col < p.b) p.out[(long long)row * p.ldo + col] = (float)sum;
  }
  cluster.sync();  // no block leaves while another reads its partial
}

int tiles(int n, int t) { return (n + t - 1) / t; }

// The contraction's split: the largest power of two up to kMaxSplit that
// keeps the blocks within kSplitTarget and gives each split at least two
// kBK steps. cuda_dense.panel_splits mirrors it.
int panel_splits(int rows, int b) {
  const int blocks = tiles(rows, kBM) * tiles(b, kBN), steps = tiles(b, kBK);
  int s = 1;
  while (2 * s <= kMaxSplit && blocks * 2 * s <= kSplitTarget && steps >= 2 * (2 * s)) s *= 2;
  return s;
}

template <bool kVecA, int kW>
cudaError_t launch(const Panel& p, cudaStream_t stream) {
  auto* kernel = panel_kernel<kVecA, kW>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  const int s = panel_splits(p.rows, p.b);
  const int kper = tiles(tiles(p.b, kBK), s) * kBK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles(p.b, kBN), (unsigned)tiles(p.rows, kBM), (unsigned)s);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p, kper);
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

template <bool kVecA>
cudaError_t launch_w(const Panel& p, int w_load, cudaStream_t stream) {
  return w_load == kWAlongK   ? launch<kVecA, kWAlongK>(p, stream)
         : w_load == kWAlongN ? launch<kVecA, kWAlongN>(p, stream)
                              : launch<kVecA, kWScalar>(p, stream);
}

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
  const Panel p{a, lda, w, w_s0, w_s1, out, ldo, rows, b};
  const bool vec_a = aligned16(a) && lda % 4 == 0 && b % 4 == 0;
  const bool vec_w = aligned16(w) && b % 4 == 0;
  const int w_load = vec_w && w_s0 == 1 && w_s1 % 4 == 0   ? kWAlongK
                     : vec_w && w_s1 == 1 && w_s0 % 4 == 0 ? kWAlongN
                                                           : kWScalar;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec_a ? launch_w<true>(p, w_load, s) : launch_w<false>(p, w_load, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The contraction's split count and the mma depth of a launch at (rows, b),
// for the plain version's order.
void dsk_panel_f64_order(int rows, int b, int* splits, int* k_step, int* mma_k) {
  *splits = panel_splits(rows, b);
  *k_step = kBK;
  *mma_k = kMmaK;
}

const char* dsk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
