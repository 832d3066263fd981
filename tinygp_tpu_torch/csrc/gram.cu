// The tiled kernel-matrix builder on Hopper (sm_90a): kernel B7, float32.
//
// Replaces the TPU kernel of tinygp_tpu/ops/pallas_gram.py: the body of
// _gram_tiled (line 107), launched by _gram_tiled (line 81, pallas_call at
// line 127) behind the public gram_tiled (line 168). It computes
// K[i, j] = k(X1[i], X2[j]) for points X1 (N, d) and X2 (M, d), row-major
// float32 ((N,) coordinates are d = 1), into a row-major (N, M) output with
// row stride ldo. Entry: gram_build.
//
// What it evaluates. The TPU kernel traces any Python evaluate() that
// Pallas lowers; CUDA cannot take Python, so this kernel is one evaluator
// for a closed set of nodes, run as a postfix program over a stack (at most
// kMaxStack deep, kMaxOps nodes). The program is built on the host by
// tinygp_tpu_torch/ops/gram.py, once per tree structure, and passed by
// value; its opcode is the same for every thread at every step, so no
// thread diverges:
//
//   kConst            push params[param]
//   kAdd, kMul        pop two, push their sum or product
//   the seven leaves  push the stationary kernel of kernels/stationary.py
//                     at the pair's distance under the leaf's metric, with
//                     its scale at params[param] (and gamma or alpha at
//                     params[param + 1])
//
// The arithmetic against the port's plain PyTorch version. Each leaf takes
// the same distance: r = distance / scale for Exp, Matern32, Matern52,
// Cosine and ExpSineSquared; r^2 = squared distance / scale^2 for
// ExpSquared and RationalQuadratic, where the squared L1 distance is
// (sum |dx|)^2, not sum dx^2 (kernels/distance.py); an L2 distance is the
// L1 sum where the squares sum to zero. The differences are taken directly,
// never as |x|^2 + |y|^2 - 2 x.y, which cancels near the diagonal. What
// differs, all within twice the float32 plain version's error plus 1e-6 of
// the largest entry (the limit tests/test_torch_cuda.py and chip_smoke.py
// hold it to):
// - each leaf's divisions are folded into constants computed in double
//   once per block and rounded once (sqrt(3)/scale, 1/(2 alpha scale^2),
//   ...), so no entry divides;
// - the five exponentials are ex2.approx of the argument times log2(e)
//   (about 2 ulp, and the argument's rounding);
// - Cosine and ExpSineSquared take cospi and sinpi of the scaled distance
//   (an exact reduction, where the plain version rounds 2 pi r to float32
//   first; at the test shapes the arguments reach tens of radians);
//   RationalQuadratic keeps the accurate powf;
// - Matern32's (1 + a) e^-a is one fused multiply-add, Matern52's
//   polynomial is Horner's with 1/3 as a product.
// A point against itself gives exactly the plain version's value: every
// leaf is exactly 1 at distance 0 (ex2(-0), cospi(0), powf(1, .)), and the
// sums and products are the same float32 operations in the same order.
// The parameters stay on the device (a float32 vector read once per block),
// so a launch reads nothing back to the host.
//
// What bounds it. B7 writes N M floats and reads (N + M) d: at N = M = 1e4
// the output is 400 MB, 0.1194 ms at 3.35 TB/s. Its arithmetic is about 3 d
// operations per entry for each metric in use plus about ten per leaf (one
// transcendental among them), about 0.03 ms at 67 TFLOP/s. So it is bound
// by the bytes it writes, and each entry's instructions have to cost
// less than its store.
//
// Design.
// - Op-major over a register tile. A thread owns kCols adjacent columns of
//   R rows (R = 4, 4, 2 or 1 by the stack's depth); the program's loop runs
//   outside the loop over those entries, so one warp-uniform dispatch (and
//   one shared-memory read of the op's constants) serves the whole tile.
//   The stack is S slots of the tile in registers, S = 1, 2, 4 or 8 by the
//   program's depth (the host's, checked here), each slot reached through a
//   tree of warp-uniform branches on the stack pointer whose leaves index
//   it at compile time: no stack frame, no local memory. The host folds
//   each product of a constant and a leaf into the leaf (its factor), so
//   the common amp * k is one op on one slot, with no push or product of
//   its own.
// - d = 1 on its own instantiation: each thread holds its R row and kCols
//   column coordinates and their differences in registers, with no shared
//   staging and no feature loop. Above, a tile's points are staged feature
//   major in shared memory (up to kMaxD features) and the L1 and L2 sums
//   formed once per entry before the program runs.
// - A warp covers kCols * 32 = 128 columns of R rows. Where the row stride
//   and the output's address allow, a thread's columns are adjacent and
//   each row is one 16-byte streaming store (st.global.cs.v4), a warp
//   writing 512 contiguous bytes; a ragged edge stores the columns inside,
//   one by one. Otherwise a thread's columns are 32 apart and every store
//   is a scalar one, still contiguous across the warp.
// - A persistent grid: as many blocks as fit on the card at once, each
//   walking the tiles (row band major) by a fixed stride and computing
//   the per-op constants once. Tiles are independent and every entry is
//   computed alone, so launches agree bit for bit; a tile's stores are in
//   flight while the next tile computes.
// Tried on an H100 and no faster at 1e4 (PERF.md §6): plain stores in
// place of streaming ones, a TMA store of the tile staged in shared memory,
// two rows a thread (more blocks, more dispatch), tiles of 4 or 8 warps side
// by side (longer row segments), and loading the next tile's coordinates
// ahead.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxOps = 64;
constexpr int kMaxStack = 8;
constexpr int kMaxParams = 2 * kMaxOps;
constexpr int kMaxD = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;               // columns a thread owns
constexpr int kTileC = 32 * kCols;     // a tile's columns: one warp's

// Opcodes; ops/gram.py holds the same numbers.
enum Op : int {
  kConst = 0,
  kAdd = 1,
  kMul = 2,
  kExp = 3,
  kExpSquared = 4,
  kMatern32 = 5,
  kMatern52 = 6,
  kCosine = 7,
  kExpSineSquared = 8,
  kRationalQuadratic = 9,
};
constexpr int kL1 = 0;
constexpr int kL2 = 1;

constexpr float kLog2e = 1.4426950408889634f;

// Rows a thread owns at stack depth S: 16 entries a thread for the shallow
// programs, fewer where the stack's slots take the registers.
template <int S>
constexpr int kRowsFor = S <= 2 ? 4 : S <= 4 ? 2 : 1;

}  // namespace

// The program, passed by value; the same layout as ops/gram.py's
// ctypes.Structure.
struct GramProgram {
  int n_ops;
  int n_params;
  int uses_l1;
  int uses_l2;
  int depth;  // the deepest the stack gets
  int op[kMaxOps];
  int metric[kMaxOps];
  int param[kMaxOps];
  int factor[kMaxOps];  // a leaf's constant factor: its parameter offset, or -1
};

namespace {

// An op as the block reads it: opcode, metric, two constants and the
// leaf's constant factor (1 where it has none).
struct OpInfo {
  int op, metric;
  float c0, c1, factor;
};

// 2^x, ex2.approx: about 2 ulp; exactly 1 at x = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The op's constants, from the parameter vector, in double and rounded
// once: what each entry multiplies by in place of a division.
__device__ OpInfo op_info(const GramProgram& prog, int o, const float* params) {
  const int op = prog.op[o];
  const float* p = params + prog.param[o];
  OpInfo info{op, prog.metric[o], 0.0f, 0.0f,
              prog.factor[o] < 0 ? 1.0f : params[prog.factor[o]]};
  const double scale = op > kMul ? double(p[0]) : 1.0;
  switch (op) {
    case kConst:
      info.c0 = p[0];
      break;
    case kExp:  // 2^(-dist c0)
      info.c0 = float(1.4426950408889634 / scale);
      break;
    case kExpSquared:  // 2^(-sq c0)
      info.c0 = float(0.5 * 1.4426950408889634 / (scale * scale));
      break;
    case kMatern32:  // a = dist c0
      info.c0 = float(1.7320508075688772 / scale);
      break;
    case kMatern52:
      info.c0 = float(2.23606797749979 / scale);
      break;
    case kCosine:  // cospi(dist c0)
      info.c0 = float(2.0 / scale);
      break;
    case kExpSineSquared:  // s = sinpi(dist c0), 2^(-c1 s^2)
      info.c0 = float(1.0 / scale);
      info.c1 = float(double(p[1]) * 1.4426950408889634);
      break;
    case kRationalQuadratic:  // powf(1 + sq c0, c1)
      info.c0 = float(1.0 / (2.0 * double(p[1]) * scale * scale));
      info.c1 = -p[1];
      break;
    default:
      break;
  }
  return info;
}

// A slot index known at compile time.
template <int K>
struct Slot {
  static constexpr int k = K;
};

// f(Slot<s>) for the run-time slot Lo <= s < Hi: a tree of warp-uniform
// branches (no jump table) whose every leaf names its slot at compile
// time, so the stack stays in registers.
template <int Lo, int Hi, class F>
__device__ __forceinline__ void with_slot(int s, F&& f) {
  if constexpr (Hi - Lo == 1) {
    f(Slot<Lo>{});
  } else {
    constexpr int mid = (Lo + Hi) / 2;
    if (s < mid) {
      with_slot<Lo, mid>(s, f);
    } else {
      with_slot<mid, Hi>(s, f);
    }
  }
}

// The T entries' L1 sums and L2 sums of squares: on points of one feature
// from the differences alone, else both sums.
template <int T, bool D1>
struct Sums {
  float s1[T], s2[T];
  __device__ __forceinline__ float l1(int t) const { return s1[t]; }
  __device__ __forceinline__ float l2(int t) const { return s2[t]; }
};

template <int T>
struct Sums<T, true> {
  float diff[T];
  __device__ __forceinline__ float l1(int t) const { return fabsf(diff[t]); }
  __device__ __forceinline__ float l2(int t) const { return diff[t] * diff[t]; }
};

// A leaf's value at each of the T entries: the distance by the op's
// metric, then the leaf's profile.
template <int T, bool D1>
__device__ __forceinline__ void leaf(const OpInfo& o, const Sums<T, D1>& g, float (&x)[T]) {
  const bool squared = o.op == kExpSquared || o.op == kRationalQuadratic;
  if (squared) {
    if (o.metric == kL1) {
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = g.l1(t) * g.l1(t);
    } else {
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = g.l2(t);
    }
  } else if (o.metric == kL1) {
#pragma unroll
    for (int t = 0; t < T; ++t) x[t] = g.l1(t);
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float sq = g.l2(t);
      x[t] = sq == 0.0f ? g.l1(t) : sqrtf(sq);
    }
  }
  switch (o.op) {
    case kExp:
    case kExpSquared:
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = fast_exp2(-(x[t] * o.c0));
      break;
    case kMatern32:
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float a = x[t] * o.c0;
        const float e = fast_exp2(-(a * kLog2e));
        x[t] = fmaf(a, e, e);
      }
      break;
    case kMatern52:
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float a = x[t] * o.c0;
        const float e = fast_exp2(-(a * kLog2e));
        x[t] = fmaf(a, fmaf(a, 1.0f / 3.0f, 1.0f), 1.0f) * e;
      }
      break;
    case kCosine:
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = cospif(x[t] * o.c0);
      break;
    case kExpSineSquared:
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float s = sinpif(x[t] * o.c0);
        x[t] = fast_exp2(-(o.c1 * s * s));
      }
      break;
    default:  // kRationalQuadratic
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = powf(1.0f + x[t] * o.c0, o.c1);
      break;
  }
  if (o.factor != 1.0f) {  // the plain version's product with the constant
#pragma unroll
    for (int t = 0; t < T; ++t) x[t] *= o.factor;
  }
}

// B7 at stack depth S (at most), on points of one feature (D1) or of d.
// Thread (warp w, lane l) of a tile at (r0, c0) owns rows r0 + w R + i,
// i < R, and columns c0 + kCols l + k (adjacent: vec) or c0 + l + 32 k,
// k < kCols.
template <int S, bool D1>
__global__ void __launch_bounds__(kThreads, 1)
    gram_kernel(const float* __restrict__ x1, int n1, const float* __restrict__ x2, int n2,
                int d, const GramProgram prog, const float* __restrict__ params,
                float* __restrict__ out, long long ldo, bool vec) {
  constexpr int R = kRowsFor<S>;
  constexpr int T = R * kCols;
  constexpr int kTileR = kWarps * R;
  extern __shared__ float smem[];  // D1: unused; else [d][kTileR] rows, [d][kTileC] columns
  __shared__ OpInfo info[kMaxOps];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int o = tid; o < prog.n_ops; o += kThreads) info[o] = op_info(prog, o, params);
  __syncthreads();

  const int tiles_c = (n2 + kTileC - 1) / kTileC;
  const int tiles = ((n1 + kTileR - 1) / kTileR) * tiles_c;
  // Where a thread's column k lies in the tile.
  const int col_base = vec ? kCols * lane : lane;
  const int col_step = vec ? 1 : 32;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = (tile / tiles_c) * kTileR;
    const int c0 = (tile % tiles_c) * kTileC;
    const int row0 = r0 + warp * R;

    Sums<T, D1> g;
    if constexpr (D1) {
      float xr[R], xc[kCols];
#pragma unroll
      for (int i = 0; i < R; ++i) xr[i] = row0 + i < n1 ? __ldg(x1 + row0 + i) : 0.0f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int col = c0 + col_base + k * col_step;
        xc[k] = col < n2 ? __ldg(x2 + col) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) g.diff[i * kCols + k] = xr[i] - xc[k];
      }
    } else {
      float* a = smem;                // [d][kTileR]
      float* b = smem + d * kTileR;   // [d][kTileC]
      __syncthreads();  // the last tile's reads are done
      for (int e = tid; e < kTileR * d; e += kThreads) {
        const int i = e / d, k = e % d;
        a[k * kTileR + i] = r0 + i < n1 ? x1[(long long)(r0 + i) * d + k] : 0.0f;
      }
      for (int e = tid; e < kTileC * d; e += kThreads) {
        const int j = e / d, k = e % d;
        b[k * kTileC + j] = c0 + j < n2 ? x2[(long long)(c0 + j) * d + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < T; ++t) g.s1[t] = g.s2[t] = 0.0f;
      const bool l1 = prog.uses_l1, l2 = prog.uses_l2;
#pragma unroll 1
      for (int k = 0; k < d; ++k) {
        float xr[R], xc[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) xr[i] = a[k * kTileR + warp * R + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) xc[c] = b[k * kTileC + col_base + c * col_step];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float diff = xr[i] - xc[c];
            if (l1) g.s1[i * kCols + c] += fabsf(diff);
            if (l2) g.s2[i * kCols + c] += diff * diff;
          }
        }
      }
    }

    // The program, op-major over the tile.
    float stack[S][T];
    int sp = 0;
#pragma unroll 1
    for (int o = 0; o < prog.n_ops; ++o) {
      const OpInfo op = info[o];
      if (op.op == kAdd || op.op == kMul) {
        const bool mul = op.op == kMul;
        if constexpr (S > 1) {  // a program of depth 1 combines nothing
          with_slot<1, S>(sp - 1, [&](auto slot) {
            constexpr int k = decltype(slot)::k;
            if (mul) {
#pragma unroll
              for (int t = 0; t < T; ++t) stack[k - 1][t] *= stack[k][t];
            } else {
#pragma unroll
              for (int t = 0; t < T; ++t) stack[k - 1][t] += stack[k][t];
            }
          });
        }
        --sp;
      } else {
        float x[T];
        if (op.op == kConst) {
#pragma unroll
          for (int t = 0; t < T; ++t) x[t] = op.c0;
        } else {
          leaf(op, g, x);
        }
        with_slot<0, S>(sp, [&](auto slot) {
          constexpr int k = decltype(slot)::k;
#pragma unroll
          for (int t = 0; t < T; ++t) stack[k][t] = x[t];
        });
        ++sp;
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + i;
      if (row >= n1) break;
      float* dst = out + (long long)row * ldo + c0 + col_base;
      if (vec && c0 + col_base + kCols <= n2) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(stack[0][i * kCols], stack[0][i * kCols + 1],
                           stack[0][i * kCols + 2], stack[0][i * kCols + 3]));
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (c0 + col_base + k * col_step < n2) {
            __stcs(dst + k * col_step, stack[0][i * kCols + k]);
          }
        }
      }
    }
  }
}

// The deepest the stack gets, if the program is one the kernel can run
// (known opcodes, parameter offsets inside the vector, a stack that never
// underflows, never passes prog.depth or kMaxStack and ends holding one
// value); else 0.
int checked_depth(const GramProgram& prog) {
  if (prog.n_ops < 1 || prog.n_ops > kMaxOps) return 0;
  if (prog.n_params < 0 || prog.n_params > kMaxParams) return 0;
  if (prog.depth < 1 || prog.depth > kMaxStack) return 0;
  int sp = 0, deepest = 0;
  for (int o = 0; o < prog.n_ops; ++o) {
    const int op = prog.op[o];
    if (op == kAdd || op == kMul) {
      if (sp < 2 || prog.factor[o] != -1) return 0;
      --sp;
      continue;
    }
    if (op < kConst || op > kRationalQuadratic) return 0;
    const int width = (op == kExpSineSquared || op == kRationalQuadratic) ? 2 : 1;
    if (prog.param[o] < 0 || prog.param[o] + width > prog.n_params) return 0;
    const int f = prog.factor[o];
    if (f != -1 && (op == kConst || f < 0 || f >= prog.n_params)) return 0;
    if (op != kConst) {
      const int m = prog.metric[o];
      const bool squared = op == kExpSquared || op == kRationalQuadratic;
      if (m != kL1 && m != kL2) return 0;
      if ((m == kL1 || !squared) && !prog.uses_l1) return 0;
      if (m == kL2 && !prog.uses_l2) return 0;
    }
    if (++sp > prog.depth) return 0;
    if (sp > deepest) deepest = sp;
  }
  return sp == 1 && deepest == prog.depth ? deepest : 0;
}

template <int S, bool D1>
int launch(const float* x1, int n1, const float* x2, int n2, int d, const GramProgram& prog,
           const float* params, float* out, long long ldo, bool vec, cudaStream_t stream) {
  constexpr int kTileR = kWarps * kRowsFor<S>;
  const long long tiles =
      ((n1 + (long long)kTileR - 1) / kTileR) * ((n2 + (long long)kTileC - 1) / kTileC);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = D1 ? 0 : sizeof(float) * (size_t)d * (kTileR + kTileC);
  // The persistent grid: every block that fits on the card at once (found
  // once per instantiation, at the most shared memory it takes).
  static int per_sm = 0;
  if (per_sm == 0) {
    const size_t most = D1 ? 0 : sizeof(float) * (size_t)kMaxD * (kTileR + kTileC);
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gram_kernel<S, D1>, kThreads, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = n > 0 ? n : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long grid = sms > 0 ? (long long)per_sm * sms : 1;
  gram_kernel<S, D1><<<(unsigned)(tiles < grid ? tiles : grid), kThreads, smem, stream>>>(
      x1, n1, x2, n2, d, prog, params, out, ldo, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B7: out[i * ldo + j] = k(x1[i], x2[j]) for i < n1, j < n2, points of d
// features, row-major float32, on `stream`, by the program `*program` (a
// host pointer). `params` is a device pointer to its n_params floats.
// Returns 0, cudaErrorInvalidValue for arguments the kernel does not take,
// or the launch's error.
int gram_build(const float* x1, long long n1, const float* x2, long long n2, int d,
               const GramProgram* program, const float* params, float* out, long long ldo,
               void* stream) {
  const GramProgram& prog = *program;
  const int depth = checked_depth(prog);
  // Row and column indices, a tile past the edge included, stay below 2^31.
  if (n1 < 1 || n2 < 1 || n1 > 0x7fff0000LL || n2 > 0x7fff0000LL || d < 1 || d > kMaxD ||
      ldo < n2 || depth == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Adjacent columns and 16-byte stores where every row starts 16-byte
  // aligned.
  const bool vec = ldo % kCols == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int a = (int)n1, b = (int)n2;
  if (depth == 1) {
    return d == 1 ? launch<1, true>(x1, a, x2, b, d, prog, params, out, ldo, vec, s)
                  : launch<1, false>(x1, a, x2, b, d, prog, params, out, ldo, vec, s);
  }
  if (depth == 2) {
    return d == 1 ? launch<2, true>(x1, a, x2, b, d, prog, params, out, ldo, vec, s)
                  : launch<2, false>(x1, a, x2, b, d, prog, params, out, ldo, vec, s);
  }
  if (depth <= 4) {
    return d == 1 ? launch<4, true>(x1, a, x2, b, d, prog, params, out, ldo, vec, s)
                  : launch<4, false>(x1, a, x2, b, d, prog, params, out, ldo, vec, s);
  }
  return d == 1 ? launch<8, true>(x1, a, x2, b, d, prog, params, out, ldo, vec, s)
                : launch<8, false>(x1, a, x2, b, d, prog, params, out, ldo, vec, s);
}

int gram_max_ops() { return kMaxOps; }
int gram_max_stack() { return kMaxStack; }
int gram_max_d() { return kMaxD; }

const char* gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
