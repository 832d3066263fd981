// The blocked dense Cholesky's matrix products on Hopper's tensor cores
// (sm_90a): kernels B4, B5 and B6, float32 in and out, bf16 splits on
// wgmma inside.
//
// Replaces three TPU kernels of tinygp_tpu/ops/pallas_dense.py:
//
//   B4  _make_syrk_inplace_kernel (line 158), launched by syrk_sub_inplace
//       (line 201, pallas_call at line 273): in place, T[off:, off:] -= L L^T
//       on the lower tiles of the trailing submatrix, and with `ak` the row
//       side products rowsq[r] = sum_c L[r, c]^2 and rsu[r] = sum_c L[r, c]
//       ak[c] (pallas_dense.py:177-196). Entry: dsk_syrk_inplace_tc.
//   B5  _make_panel_kernel (line 315), launched by split_panel_matmul
//       (line 322, pallas_call at line 351): out = A[r0:r0+rows, c0:c0+b] @ W,
//       the panel read in place through A's row stride. Entry:
//       dsk_panel_matmul.
//   B6  _make_syrk_kernel (line 93), launched by syrk_sub (line 112,
//       pallas_call at line 139): out = T - L L^T out of place; with
//       lower_only, zeros where col / tile > row / tile at the caller's
//       `tile`. Entry: dsk_syrk.
//
// What they compute. The TPU kernels split each float32 operand into bf16
// pieces (pallas_dense.py:44-89): _split2 gives x ~ h + l, _split3
// x ~ h + m + l, and _split_dots sums the piece products that matter:
// h h' + (h l' + l h') for 2 terms (about 2^-16), and h h' + (h m' + m h')
// + (h l' + (l h' + m m')) for 3 (about 2^-24). A product of two bf16
// pieces is exact in float32, so only the accumulation rounds.
//
// The three compute the six products of 3 terms, with float32 sums, for
// either order. The 2-term products missed the port's limits on the
// main path: with them, the dense gradient at N = 1e4 (bench.py's
// Matern32) erred 2.3% against float64, where its limit is 0.2%, and 1.8%
// at N = 4500 (PERF.md, PR 7), while the float32 sums of the kernels they
// replace met it. B5's 3-term order, which the factorization asks for on
// ill-conditioned matrices, needs float64 sums and stays in dense_syrk.cu
// (its note says why); the wrapper picks it by `terms`.
//
// Design. Two passes per call.
//
// 1. The split pass (split_kernel): an elementwise kernel reads a float32
//    operand through its own row and column strides and writes its three
//    bf16 pieces K-major into scratch the caller allocates, zero-padded to
//    kRowPad rows and a multiple of kBK columns, 16 bytes a store. It
//    rounds in _split3's order (h = bf16(x), r = x - h, m = bf16(r),
//    l = bf16(r - m)), and its subtractions flush subnormal inputs and
//    results to zero, as the TPU and XLA do: the pieces equal the JAX
//    package's bit for bit, and (h, m) is _split2's (h, l). B5 splits the
//    panel and W^T in one launch (W read through its strides, so a
//    transposed view costs no copy); B4 and B6 split L once and read it on
//    both sides. Only this pass reads the caller's float32, so the GEMM's
//    TMA loads need no alignment from the caller. For B4 with `ak` the same
//    launch then computes the row side products, a warp per row of L
//    (row_sums: a fixed order, no fused multiply-add), so B4 needs no third
//    pass and its GEMM no extra epilogue.
// 2. One bf16 tensor-core GEMM body in NT form (tc_gemm), out = P Q^T over
//    the six piece pairs, launched as the split pass's programmatic
//    dependent so that its launch and prologue overlap the split. A block
//    of 384 threads owns a 128 x 128 output tile. Warpgroup 2 is
//    the producer: it gives its registers to the consumers (setmaxnreg),
//    and its one thread keeps a ring of stages full with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle), each stage one 64-wide
//    k-chunk of the three pieces of both operands, guarded by a full and an
//    empty mbarrier. Warpgroups 0 and 1 are the consumers, each owning 64
//    rows of the tile and issuing wgmma.m64n64k16 (bf16 in shared memory,
//    float32 accumulators in registers), 64 output columns at a time.
//
//    Accumulation. The tensor cores add each k step's products to the
//    accumulator and round the result toward zero. Summed that way over a
//    512-deep contraction, the bias of B5's output moved the dense
//    gradient at N = 4500 past its limit (tests/test_torch_cuda.py,
//    test_dense_gp_on_the_card_matches_cpu), which unbiased float32 sums of
//    the same products meet. So the tensor cores' rounding stays only where
//    it is negligible: the five small pairs (about 2^-8 of the whole) go
//    into a fresh accumulator as one group, and the large pair (h, h) runs
//    one k step at a time, twice: into a fresh accumulator, giving a = its
//    rounded sum, then onto -a, giving exactly the part a lost. Every
//    group's result is added to the tile's float32 sums on the CUDA cores,
//    which round to nearest (chip_smoke.py prints the bias that is left).
//    Three accumulators take turns (slot_job), so three groups are in
//    flight while a fourth is folded; four would spill.
//
//    B5: a 2-d grid of 128 x 128 tiles.
//    B6: a 1-d grid over the lower 128 x 128 tile pairs (i, j <= i), each
//    block decoding its pair from blockIdx.x. It writes T - acc on tile
//    (i, j) and, for i != j, T - acc^T on the mirrored tile (j, i), read
//    transposed out of shared memory so the stores stay coalesced; L L^T
//    is symmetric, so half the multiply work is skipped.
//    With lower_only every element with col / tile > row / tile is zero
//    (T is not read there), whatever the caller's tile against 128. Each
//    thread issues its loads of T in batches, so their latencies overlap.
//    B4: B6's grid over the lower tile pairs of the trailing submatrix,
//    in place at the caller's offset and leading dimension: it writes
//    T - acc on tile (i, j) and nothing else. So the diagonal tiles are
//    updated whole and the strictly upper ones are never touched (the
//    factorization reads only the lower triangle). T is read and written
//    through one pointer (syrk_store's kInPlace). Every store is masked to
//    the trailing size, which need not be a multiple of 128.
//    All stage their float32 sums in shared memory and store coalesced.
//
// What bounds them (chip_smoke.py prints each time beside its bound). At
// the main path's shapes (N = 1e4 padded to m = 10240, b = 512, panels of
// 512 j rows, j = 1..19) B5 does 2 rows b^2 float32-grade flops per
// panel, 5.1e10 over one factorization: 0.31 ms at the 3-term tensor-core
// rate (989/6 TFLOP/s), its bound, against about 0.12 ms for its bytes.
// B6 at benchmarks/dense_micro.py's shapes does m (m + 1) b flops (the
// distinct dot products) and moves T, L and the output once: 0.90 ms over
// the three shapes, about half of it bytes. B4 over one factorization's
// 19 trailing sizes does sum_j 512 (512 j)^2 = 3.3e11 flops: 2.0 ms at
// the same rate, against about 0.8 ms for its bytes. At the smallest
// sizes its grid (10 to 136 tile pairs, one block an SM) leaves SMs idle.
//
// Left for later: a persistent grid whose epilogue overlaps the next
// tile's loads (and fills the SMs at B4's small trailing sizes), and
// splitting B5's panel in registers (the RS form of wgmma), which would
// save the split pass's bytes and its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kBM = 128;        // output tile rows (two warpgroups of 64)
constexpr int kBK = 64;         // k-chunk: 64 bf16, one 128-byte swizzle row
constexpr int kRowPad = 128;    // the pieces' rows are padded to this
constexpr int kPieces = 3;      // h, m, l
constexpr int kConsumers = 256; // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// Registers a thread: the kernel starts at 168 (65536 over 384 threads);
// the producer warpgroup gives up what the consumers take
// (128 x (168 - 40) = 256 x (232 - 168)).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSplitThreads = 256;
constexpr int kEncodeFailed = 20000;  // + the CUresult of a failed encode

long long pad(long long n, long long to) { return (n + to - 1) / to * to; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a - b with subnormal inputs and result flushed to signed zero (the
// TPU's and XLA's float32 arithmetic).
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One operand of the split pass: x (rows, k), x[r, c] at
// x[r * s_row + c * s_col], into out[p][r][c] (kPieces planes of
// rows_pad x k_pad bf16), zeros outside x.
struct SplitOp {
  const float* x;
  long long s_row, s_col;
  int rows, k, rows_pad, k_pad;
  __nv_bfloat16* out;
};

// The pieces of one group of 8 consecutive columns of one row, as _split3
// rounds them, stored 16 bytes per piece.
__device__ __forceinline__ void split_group(const SplitOp& op, long long g) {
  const long long groups_per_row = op.k_pad / 8;
  long long r, kg;
  if (op.s_col == 1) {  // neighbouring threads along the row: coalesced reads
    r = g / groups_per_row;
    kg = g % groups_per_row;
  } else {  // along the column, where x's rows are contiguous (W^T)
    kg = g / op.rows_pad;
    r = g % op.rows_pad;
  }
  float v8[8];
  const float* src = op.x + r * op.s_row + kg * 8 * op.s_col;
  if (op.s_col == 1 && r < op.rows && kg * 8 + 8 <= op.k &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {  // two 16-byte loads
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    v8[0] = lo.x, v8[1] = lo.y, v8[2] = lo.z, v8[3] = lo.w;
    v8[4] = hi.x, v8[5] = hi.y, v8[6] = hi.z, v8[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long c = kg * 8 + i;
      v8[i] = (r < op.rows && c < op.k) ? src[i * op.s_col] : 0.0f;
    }
  }
  uint32_t w[kPieces][4] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = v8[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    const float res = sub_ftz(v, __bfloat162float(h));
    const __nv_bfloat16 m = __float2bfloat16_rn(res);
    const __nv_bfloat16 l = __float2bfloat16_rn(sub_ftz(res, __bfloat162float(m)));
    const int sh = 16 * (i & 1);
    w[0][i / 2] |= (uint32_t)__bfloat16_as_ushort(h) << sh;
    w[1][i / 2] |= (uint32_t)__bfloat16_as_ushort(m) << sh;
    w[2][i / 2] |= (uint32_t)__bfloat16_as_ushort(l) << sh;
  }
  const long long plane = (long long)op.rows_pad * op.k_pad / 8;  // in uint4
  uint4* dst = reinterpret_cast<uint4*>(op.out + r * op.k_pad + kg * 8);
#pragma unroll
  for (int p = 0; p < kPieces; ++p) dst[p * plane] = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

// B4's row side products over x (rows, k), x[r, c] at x[r * s_row + c]:
// rowsq[r] = sum_c x[r, c]^2 and rsu[r] = sum_c x[r, c] ak[c]. None where
// ak is null.
struct RowSums {
  const float* x;
  long long s_row;
  int rows, k;
  const float* ak;
  float* rowsq;
  float* rsu;
};

// One row's side products, by one warp, in a fixed order: lane i sums
// columns i, i + 32, ... in turn, each product rounded before its sum (no
// fused multiply-add, so plain_syrk_inplace_by_tiles repeats it bit for
// bit), then a butterfly over the lanes.
__device__ __forceinline__ void row_sums(const RowSums& rs, long long r, int lane) {
  const float* row = rs.x + r * rs.s_row;
  float sq = 0.0f, su = 0.0f;
  for (int c = lane; c < rs.k; c += 32) {
    const float v = row[c];
    sq = __fadd_rn(sq, __fmul_rn(v, v));
    su = __fadd_rn(su, __fmul_rn(v, rs.ak[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
    su += __shfl_xor_sync(0xffffffffu, su, o);
  }
  if (lane == 0) {
    rs.rowsq[r] = sq;
    rs.rsu[r] = su;
  }
}

// The split pass over one or two operands in one launch: the first
// groups_a groups are a's, the rest b's; then, where rs.ak is set, the
// row side products, a warp per row.
__global__ void __launch_bounds__(kSplitThreads)
    split_kernel(SplitOp a, SplitOp b, RowSums rs, long long groups_a, long long groups) {
  // The GEMM that reads the pieces may start its prologue now; it waits
  // for this grid to finish before its first load (griddepcontrol.wait).
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  for (long long g = (long long)blockIdx.x * kSplitThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kSplitThreads) {
    if (g < groups_a)
      split_group(a, g);
    else
      split_group(b, g - groups_a);
  }
  if (rs.ak) {
    const long long warps = (long long)gridDim.x * (kSplitThreads / 32);
    for (long long r = ((long long)blockIdx.x * kSplitThreads + threadIdx.x) / 32; r < rs.rows;
         r += warps)
      row_sums(rs, r, threadIdx.x % 32);
  }
}

// ---- mbarriers and TMA -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with this parity has completed. A wait
// past kWatchdogNs traps, so a broken pipeline fails its launch instead of
// hanging the card (a healthy wait is microseconds).
constexpr uint64_t kWatchdogNs = 10000000000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (!start) {
      start = global_ns();
    } else if (global_ns() - start > kWatchdogNs) {
      __trap();
    }
  }
}

// One box of `map` at (c0 along k, c1 along rows) into dst, completing
// on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------

// The descriptor of a K-major bf16 tile in shared memory written by TMA
// with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes
// apart (SBO), the leading offset unused. The tile is 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// acc (m64 x n64, this thread's 32 floats) += A B^T, both bf16 K-major
// in shared memory behind the descriptors (K = 16).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the GEMM body -----------------------------------------------------

// The six piece pairs of _split_dots at 3 terms, smallest first: (l, h),
// (m, m), (h, l), (m, h), (h, m), (h, h). Pair q multiplies piece
// pair_a(q) of P by piece pair_b(q) of Q. The five small pairs are about
// 2^-8 of (h, h) and share one accumulator; (h, h) runs alone (issue_hh
// says why).
constexpr int kPairs = 6;
__device__ __forceinline__ int pair_a(int q) { return q == 0 ? 2 : q == 1 || q == 3 ? 1 : 0; }
__device__ __forceinline__ int pair_b(int q) { return q == 2 ? 2 : q == 1 || q == 4 ? 1 : 0; }

// The output tile is kBM x kBN. The consumers' accumulators are 64 x 64:
// a warpgroup's 64 rows by one 64-column half of the tile (32 floats a
// thread), so that three can be in flight beside the float32 sums of both
// halves.
constexpr int kBN = 128;
constexpr int kHalf = 64;
constexpr int kHalves = kBN / kHalf;
constexpr int kHalfAcc = kHalf / 2;
constexpr int kAcc = kHalves * kHalfAcc;  // the sums' floats a thread

// The ring: each stage holds one k-chunk of the three pieces of both
// operands' tiles.
constexpr int kStageA = kPieces * kBM * kBK * 2;  // bytes
constexpr int kStageB = kPieces * kBN * kBK * 2;
constexpr int kStage = kStageA + kStageB;
constexpr int kStages = (200 * 1024) / kStage;
constexpr int kBars = kStages * kStage;  // the barriers' offset
constexpr int kSmem = 1024 + kBars + 2 * kStages * 8;
constexpr int kLd = kBN + 1;  // the epilogue's staging row, against bank conflicts
static_assert(kStages >= 2, "two stages at least");
static_assert(kSmem <= 232448, "shared memory of one block");
static_assert(kBM * kLd * 4 <= kBars, "the epilogue's staging fits the ring");

// The (i, j), j <= i, of lower tile pair g in row-major order.
__device__ __forceinline__ void lower_pair(long long g, int& i, int& j) {
  long long r = (long long)((sqrt(8.0 * (double)g + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > g) --r;
  while ((r + 1) * (r + 2) / 2 <= g) ++r;
  i = (int)r;
  j = (int)(g - r * (r + 1) / 2);
}

// B6's and B4's stores of one tile from the staged sums acc ([kBM][kLd]):
// out[R][C] = T[R][C] - acc, or 0 where lower_only zeroes it. Direct:
// R = row0 + r, C = col0 + c, acc[r][c]; kMirror: R = col0 + c,
// C = row0 + r, acc[r][c] again (neighbouring threads along C). kInPlace
// (B4): T is out itself, read and written through out alone (t is null),
// so no two restrict pointers alias. Each thread loads kBatch elements of
// T before it stores any.
template <bool kMirror, bool kInPlace>
__device__ __forceinline__ void syrk_store(const float* acc, int row0, int col0, int m,
                                           const float* __restrict__ t, long long ldt,
                                           float* __restrict__ out, long long ldo,
                                           int lower_only, int tile) {
  constexpr int kBatch = 16;
  static_assert((kBM * kBN) % (kConsumers * kBatch) == 0, "whole batches");
  static_assert(!(kMirror && kInPlace), "B4 writes no mirror");
  for (int base = threadIdx.x; base < kBM * kBN; base += kConsumers * kBatch) {
    float tv[kBatch];
    int at[kBatch];  // the element's index in acc; -1 outside out, -2 a zero
    long long dst[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kConsumers;
      const int r = kMirror ? idx % kBM : idx / kBN, c = kMirror ? idx / kBM : idx % kBN;
      const int R = kMirror ? col0 + c : row0 + r, C = kMirror ? row0 + r : col0 + c;
      const bool in = R < m && C < m;
      const bool zero = lower_only && C / tile > R / tile;
      at[u] = !in ? -1 : zero ? -2 : r * kLd + c;
      dst[u] = (long long)R * ldo + C;
      tv[u] = at[u] < 0 ? 0.0f : kInPlace ? out[dst[u]] : t[(long long)R * ldt + C];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) out[dst[u]] = tv[u] - acc[at[u]];
      else if (at[u] == -2) out[dst[u]] = 0.0f;
    }
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Issue the five small pairs of the k-chunk in stage `st`, for output
// columns 64 kH .. 64 kH + 63, into a fresh accumulator as one wgmma
// group.
template <int kH>
__device__ __forceinline__ void issue_small(float (&acc)[kHalfAcc], const unsigned char* st,
                                            int wg) {
#pragma unroll
  for (int i = 0; i < kHalfAcc; ++i) acc[i] = 0.0f;
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < kPairs - 1; ++q) {
    const uint64_t da = sw128_desc(st + pair_a(q) * kBM * kBK * 2 + wg * 64 * kBK * 2);
    const uint64_t db = sw128_desc(st + kStageA + (pair_b(q) * kBN + kH * kHalf) * kBK * 2);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
  }
  wgmma_commit();
  fence_operands(acc);
}

// Issue (h, h) at k step kK for the same columns as one wgmma group. The
// tensor cores round each step's sum toward zero, a bias the float32 sum
// would keep, so every step runs twice: fresh, into a zeroed accumulator,
// giving a = the rounded sum; then onto -a, giving the part of the sum a
// lost, exactly. Both are folded into the float32 sum, which rounds to
// nearest.
template <int kH, int kK, bool kFresh>
__device__ __forceinline__ void issue_hh(float (&acc)[kHalfAcc], const unsigned char* st,
                                         int wg) {
  if (kFresh) {
#pragma unroll
    for (int i = 0; i < kHalfAcc; ++i) acc[i] = 0.0f;
  }
  fence_operands(acc);
  wgmma_fence();
  wgmma_bf16(acc, sw128_desc(st + wg * 64 * kBK * 2) + 2 * kK,
             sw128_desc(st + kStageA + kH * kHalf * kBK * 2) + 2 * kK);
  wgmma_commit();
  fence_operands(acc);
}

// The jobs of one k-chunk, in slots: per half the small batch (S), then
// (h, h) at each k step, first pass (F) and, three slots later, second
// pass (C). Slot p runs on accumulator p % 3, so a step's second pass finds
// its first pass's accumulator; after slot p is issued, slot p - 2 is
// waited for and folded, so three groups are in flight (four accumulators
// would spill). Slot 17 is an empty group.
//   slot  0  1  2  3  4  5  6  7  8  9 10 11 12 13 14 15 16 17 18
//   job   S  F  F  F  C  C  C  F  S  F  C  F  C  F  C  F  C  -  C
//   half  0  0  0  0  0  0  0  0  1  1  0  1  1  1  1  1  1  -  1
//   step     0  1  2  0  1  2  3     0  3  1  0  2  1  3  2     3
enum Job { kSmall, kFirst, kSecond, kIdle };
constexpr int kSlots = 19;
constexpr int kDepth = 3;  // accumulators, and groups in flight
__host__ __device__ constexpr Job slot_job(int p) {
  constexpr Job jobs[kSlots] = {kSmall,  kFirst,  kFirst,  kFirst,  kSecond, kSecond, kSecond,
                                kFirst,  kSmall,  kFirst,  kSecond, kFirst,  kSecond, kFirst,
                                kSecond, kFirst,  kSecond, kIdle,   kSecond};
  return jobs[p];
}
__host__ __device__ constexpr int slot_half(int p) {
  constexpr int halves[kSlots] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1};
  return halves[p];
}
__host__ __device__ constexpr int slot_step(int p) {
  constexpr int steps[kSlots] = {0, 0, 1, 2, 0, 1, 2, 3, 0, 0, 3, 1, 0, 2, 1, 3, 2, 0, 3};
  return steps[p];
}

template <int P>
__device__ __forceinline__ void issue_slot(float (&acc)[kHalfAcc], const unsigned char* st,
                                           int wg) {
  constexpr Job kJ = slot_job(P);
  if constexpr (kJ == kSmall)
    issue_small<slot_half(P)>(acc, st, wg);
  else if constexpr (kJ == kIdle)
    wgmma_commit();  // an empty group keeps the count of groups in flight
  else
    issue_hh<slot_half(P), slot_step(P), kJ == kFirst>(acc, st, wg);
}

// total's half += acc once slot P's group is done; after a first pass,
// acc = -acc for the step's second pass.
template <int P>
__device__ __forceinline__ void fold_slot(float (&total)[kAcc], float (&acc)[kHalfAcc]) {
  constexpr Job kJ = slot_job(P);
  constexpr int kOffset = slot_half(P) * kHalfAcc;
  if constexpr (kJ != kIdle) {
    fence_operands(acc);
#pragma unroll
    for (int i = 0; i < kHalfAcc; ++i) {
      total[kOffset + i] += acc[i];
      if (kJ == kFirst) acc[i] = -acc[i];
    }
  }
}

template <int P>
__device__ __forceinline__ void run_slot(float (&acc)[kDepth][kHalfAcc], float (&total)[kAcc],
                                         const unsigned char* st, int wg) {
  issue_slot<P>(acc[P % kDepth], st, wg);
  if constexpr (P >= kDepth - 1) {
    wgmma_wait<kDepth - 1>();
    fold_slot<P - (kDepth - 1)>(total, acc[(P - (kDepth - 1)) % kDepth]);
  }
}

template <int... P>
__device__ __forceinline__ void run_chunk(float (&acc)[kDepth][kHalfAcc], float (&total)[kAcc],
                                          const unsigned char* st, int wg,
                                          std::integer_sequence<int, P...>) {
  (run_slot<P>(acc, total, st, wg), ...);
  static_assert(kDepth == 3, "the last two slots are folded below");
  wgmma_wait<1>();
  fold_slot<kSlots - 2>(total, acc[(kSlots - 2) % kDepth]);
  wgmma_wait<0>();
  fold_slot<kSlots - 1>(total, acc[(kSlots - 1) % kDepth]);
}

// What a tc_gemm grid computes (its template argument).
constexpr int kPanel = 0;       // B5: out = P Q^T
constexpr int kSyrk = 1;        // B6: out = T - P P^T, out of place, mirrored
constexpr int kSyrkInPlace = 2; // B4: T -= P P^T in place, no mirror

// out = P Q^T over the six piece pairs, P's pieces in `ma` (planes of
// a_rows rows), Q's in `mb` (planes of b_rows rows), nk k-chunks. kPanel:
// out (rows, cols) at ldo, tile (blockIdx.y, blockIdx.x). kSyrk: the lower
// tile pair of blockIdx.x of out = T - P P^T, m = rows = cols.
// kSyrkInPlace: the same pair of out -= P P^T (t null), its diagonal tiles
// whole, the strictly upper tiles never touched.
template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
    tc_gemm(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
            int a_rows, int b_rows, int nk, float* __restrict__ out, long long ldo, int rows,
            int cols, const float* __restrict__ t, long long ldt, int lower_only, int tile) {
  static_assert(kBN == kBM, "B6 mirrors square tiles");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;

  int row0, col0;
  if (kKind != kPanel) {
    int bi, bj;
    lower_pair(blockIdx.x, bi, bj);
    row0 = bi * kBM;
    col0 = bj * kBN;
  } else {
    row0 = blockIdx.y * kBM;
    col0 = blockIdx.x * kBN;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // The producer warpgroup: one thread keeps the ring full; the group
    // gives its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      // The pieces come from the split pass launched just before this
      // grid, which may have started early (programmatic dependent launch).
      asm volatile("griddepcontrol.wait;" ::: "memory");
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % kStages;
        mbar_wait(&empty[s], ((kc / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        unsigned char* st = smem + s * kStage;
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          tma_load(st + p * kBM * kBK * 2, &ma, &full[s], kc * kBK, p * a_rows + row0);
          tma_load(st + kStageA + p * kBN * kBK * 2, &mb, &full[s], kc * kBK,
                   p * b_rows + col0);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  float acc[kDepth][kHalfAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) total[i] = 0;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % kStages;
    mbar_wait(&full[s], (kc / kStages) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    const unsigned char* st = smem + s * kStage;
    run_chunk(acc, total, st, wg, std::make_integer_sequence<int, kSlots>{});
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: both warpgroups are done reading the ring; stage the sums in
  // shared memory, [kBM][kLd], then write coalesced.
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  float* stage_c = reinterpret_cast<float*>(smem);
  {
    const int tw = (threadIdx.x % 128) / 32;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int h = i / kHalfAcc, f = i % kHalfAcc;  // half, index in its fragment
      const int r = wg * 64 + tw * 16 + lane / 4 + 8 * ((f >> 1) & 1);
      const int c = h * kHalf + 8 * (f >> 2) + 2 * (lane & 3) + (f & 1);
      stage_c[r * kLd + c] = total[i];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

  if constexpr (kKind == kPanel) {
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kConsumers) {
      const int r = idx / kBN, c = idx % kBN;
      const int R = row0 + r, Cc = col0 + c;
      if (R < rows && Cc < cols) out[(long long)R * ldo + Cc] = stage_c[r * kLd + c];
    }
  } else if constexpr (kKind == kSyrkInPlace) {
    syrk_store<false, true>(stage_c, row0, col0, rows, nullptr, 0, out, ldo, 0, 1);
  } else {
    syrk_store<false, false>(stage_c, row0, col0, rows, t, ldt, out, ldo, lower_only, tile);
    if (row0 != col0)
      syrk_store<true, false>(stage_c, row0, col0, rows, t, ldt, out, ldo, lower_only, tile);
  }
}

// ---- host side ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// -lcuda. Returns a cudaError_t code.
int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !p) return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// The map of rows_total bf16 rows of k_pad columns at base, boxes of
// kBK x 128 rows with the 128-byte swizzle. Returns 0 or an error code.
int make_map(CUtensorMap* map, void* base, long long rows_total, int k_pad) {
  EncodeTiled fn;
  if (int e = encode_fn(&fn)) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)rows_total};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * 2};
  static_assert(kBM == kBN, "one box shape for both operands");
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

SplitOp split_op(const float* x, long long s_row, long long s_col, int rows, int k,
                 void* out) {
  return SplitOp{x, s_row, s_col, rows, k, (int)pad(rows, kRowPad), (int)pad(k, kBK),
                 static_cast<__nv_bfloat16*>(out)};
}

long long split_elems(const SplitOp& op) { return (long long)kPieces * op.rows_pad * op.k_pad; }

// The split pass of a, and of b where b.x is not null, in one launch,
// with the row side products rs where rs.ak is not null.
int launch_split(const SplitOp& a, const SplitOp& b, const RowSums& rs, cudaStream_t s) {
  const long long groups_a = (long long)a.rows_pad * a.k_pad / 8;
  const long long groups = groups_a + (b.x ? (long long)b.rows_pad * b.k_pad / 8 : 0);
  if (groups == 0) return 0;
  const long long blocks = (groups + kSplitThreads - 1) / kSplitThreads;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  split_kernel<<<grid, kSplitThreads, 0, s>>>(a, b, rs, groups_a, groups);
  return (int)cudaGetLastError();
}

template <int kKind>
int launch_gemm(dim3 grid, cudaStream_t s, const CUtensorMap& ma, const CUtensorMap& mb,
                int a_rows, int b_rows, int nk, float* out, long long ldo, int rows, int cols,
                const float* t, long long ldt, int lower_only, int tile) {
  static bool ready = false;  // the shared-memory attribute, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_gemm<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  // Launched as the split pass's dependent, so that its launch and
  // prologue overlap the split pass.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tc_gemm<kKind>, ma, mb, a_rows, b_rows, nk, out,
                                           ldo, rows, cols, t, ldt, lower_only, tile);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The split pass alone: the three pieces of x (rows, k), x[r, c] at
// x[r * s_row + c * s_col], into `pieces` (3 planes of
// pad(rows, 128) x pad(k, 64) bf16, `elems` values available). Returns a
// cudaError_t code.
int dsk_split(const float* x, long long s_row, long long s_col, int rows, int k, void* pieces,
              long long elems, void* stream) {
  if (rows < 0 || k < 0 || pad(rows, kRowPad) > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const SplitOp op = split_op(x, s_row, s_col, rows, k, pieces);
  if (elems < split_elems(op)) return (int)cudaErrorInvalidValue;
  return launch_split(op, SplitOp{}, RowSums{}, static_cast<cudaStream_t>(stream));
}

// B5 at 2 terms (3-term products, float32 sums): out (rows, b), leading
// dimension ldo, = A @ W with A the (rows, b) panel at a (leading dimension
// lda) and W (b, b) with W[k, n] at w[k * w_s0 + n * w_s1]. `scratch`
// holds the pieces of A, then those of W^T: 3 planes of pad(rows, 128) and
// of pad(b, 128) rows, each of pad(b, 64) bf16 (`elems` values available).
// Returns a cudaError_t code (20000 + a CUresult where the tensor map's
// encoding failed).
int dsk_panel_matmul(const float* a, long long lda, const float* w, long long w_s0,
                     long long w_s1, float* out, long long ldo, int rows, int b, void* scratch,
                     long long elems, void* stream) {
  if (rows < 0 || b < 1 || lda < b || ldo < b || pad(rows, kRowPad) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const SplitOp pa = split_op(a, lda, 1, rows, b, scratch);
  const SplitOp pw = split_op(w, w_s1, w_s0, b, b,
                              static_cast<__nv_bfloat16*>(scratch) + split_elems(pa));
  if (elems < split_elems(pa) + split_elems(pw)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int e = launch_split(pa, pw, RowSums{}, s)) return e;
  CUtensorMap ma, mb;
  if (int e = make_map(&ma, pa.out, (long long)kPieces * pa.rows_pad, pa.k_pad)) return e;
  if (int e = make_map(&mb, pw.out, (long long)kPieces * pw.rows_pad, pw.k_pad)) return e;
  const dim3 grid((unsigned)((b + kBN - 1) / kBN), (unsigned)(pa.rows_pad / kBM));
  return launch_gemm<kPanel>(grid, s, ma, mb, pa.rows_pad, pw.rows_pad, pa.k_pad / kBK, out, ldo,
                            rows, b, nullptr, 0, 0, 1);
}

// B6: out (m, m), leading dimension ldo, = T - L L^T with T (m, m) at t
// (leading dimension ldt) and L (m, b) at l (leading dimension ldl); with
// lower_only, zeros where col / tile > row / tile. `scratch` holds L's
// pieces: 3 planes of pad(m, 128) x pad(b, 64) bf16 (`elems` values
// available). Returns a cudaError_t code (20000 + a CUresult where the
// tensor map's encoding failed).
int dsk_syrk(const float* t, long long ldt, const float* l, long long ldl, int m, int b,
             float* out, long long ldo, int lower_only, int tile, void* scratch, long long elems,
             void* stream) {
  if (m < 0 || b < 1 || ldt < m || ldl < b || ldo < m || tile < 1)
    return (int)cudaErrorInvalidValue;
  const SplitOp pl = split_op(l, ldl, 1, m, b, scratch);
  const long long nt = pl.rows_pad / kBM, pairs = nt * (nt + 1) / 2;
  if (elems < split_elems(pl) || pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int e = launch_split(pl, SplitOp{}, RowSums{}, s)) return e;
  CUtensorMap map;
  if (int e = make_map(&map, pl.out, (long long)kPieces * pl.rows_pad, pl.k_pad)) return e;
  return launch_gemm<kSyrk>(dim3((unsigned)pairs), s, map, map, pl.rows_pad, pl.rows_pad,
                           pl.k_pad / kBK, out, ldo, m, m, t, ldt, lower_only, tile);
}

// B4: in place, t (m, m) -= L L^T on the lower 128 x 128 tile pairs, with
// t the trailing submatrix's first element (leading dimension ldt) and L
// (m, b) at l (leading dimension ldl); the diagonal tiles are updated
// whole, the strictly upper tiles are not touched. With ak (b,) not null,
// also rowsq (m,) and rsu (m,), from the split pass. `scratch` holds L's
// pieces: 3 planes of pad(m, 128) x pad(b, 64) bf16 (`elems` values
// available). Returns a cudaError_t code (20000 + a CUresult where the
// tensor map's encoding failed).
int dsk_syrk_inplace_tc(float* t, long long ldt, const float* l, long long ldl, int m, int b,
                        const float* ak, float* rowsq, float* rsu, void* scratch,
                        long long elems, void* stream) {
  if (m < 0 || b < 1 || ldt < m || ldl < b || (ak && (!rowsq || !rsu)))
    return (int)cudaErrorInvalidValue;
  const SplitOp pl = split_op(l, ldl, 1, m, b, scratch);
  const long long nt = pl.rows_pad / kBM, pairs = nt * (nt + 1) / 2;
  if (elems < split_elems(pl) || pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int e = launch_split(pl, SplitOp{}, RowSums{l, ldl, m, b, ak, rowsq, rsu}, s)) return e;
  CUtensorMap map;
  if (int e = make_map(&map, pl.out, (long long)kPieces * pl.rows_pad, pl.k_pad)) return e;
  return launch_gemm<kSyrkInPlace>(dim3((unsigned)pairs), s, map, map, pl.rows_pad, pl.rows_pad,
                                   pl.k_pad / kBK, t, ldt, m, m, nullptr, 0, 0, 1);
}

// The tensor-core GEMM's configuration: output tile rows and columns,
// ring stages and dynamic shared memory in bytes.
void dsk_gemm_config(int* bm, int* bn, int* stages, int* smem) {
  *bm = kBM, *bn = kBN, *stages = kStages, *smem = kSmem;
}

const char* dsk_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled failed (code - 20000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
