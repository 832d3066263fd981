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
// for a closed set of nodes, run as a postfix program over a register stack
// (at most kMaxStack deep, kMaxOps nodes). The program is built on the host
// by tinygp_tpu_torch/ops/gram.py and passed by value; its opcode is the
// same for every thread at every step, so no thread diverges:
//
//   kConst            push params[param]
//   kAdd, kMul        pop two, push their sum or product
//   the seven leaves  push the stationary kernel of kernels/stationary.py
//                     at the pair's distance under the leaf's metric, with
//                     its scale at params[param] (and gamma or alpha at
//                     params[param + 1])
//
// Each leaf follows the port's plain PyTorch arithmetic, in the same order
// and type: r = distance / scale for Exp, Matern32, Matern52, Cosine and
// ExpSineSquared; r^2 = squared distance / scale^2 for ExpSquared and
// RationalQuadratic, where the squared L1 distance is (sum |dx|)^2, not
// sum dx^2 (kernels/distance.py). The differences are taken directly,
// never as |x|^2 + |y|^2 - 2 x.y, which cancels near the diagonal: a point
// against itself gives exactly the kernel's variance. The maths is the
// accurate one (expf, sinf, cosf, powf; no fast-math): Cosine's and
// ExpSineSquared's arguments round in float32 as the plain version's do.
// The parameters stay on the device (a float32 vector read once per block),
// so a launch reads nothing back to the host.
//
// What bounds it. B7 writes N M floats and reads (N + M) d: at N = M = 1e4
// the output is 400 MB, 0.1194 ms at 3.35 TB/s. Its arithmetic is about 3 d
// operations per entry for each metric in use plus about ten per leaf (one
// transcendental among them), about 0.03 ms at 67 TFLOP/s. So it is bound
// by bytes: the design writes every entry once, coalesced.
//
// Design, simple first. A block of 256 threads owns a 64 x 64 output tile.
// It stages its 64 rows of X1 and 64 rows of X2 (all d features, feature-
// major so neighbouring threads read neighbouring words) in dynamic shared
// memory, then each thread evaluates one column for 16 rows: neighbouring
// threads write neighbouring columns. The L1 and L2 sums a program needs are
// formed once per entry, before the program runs (an L2 distance needs
// the L1 sum too, for its branch at zero). Ragged edges are masked.
// The grid is one-dimensional over the tiles, each block decoding its
// (row, column) tile from blockIdx.x, so neither N nor M is capped by a
// grid dimension. d runs to kMaxD (32 KB of shared memory).
//
// Left for later: the stack lives in local memory (its index is not known
// at compile time); specialising the common programs, wider stores and a
// persistent grid are the first things to try against the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 64;
constexpr int kMaxStack = 8;
constexpr int kMaxParams = 2 * kMaxOps;
constexpr int kMaxD = 64;
constexpr int kTileR = 64;
constexpr int kTileC = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileR * kTileC / kThreads;

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

}  // namespace

// The program, passed by value; the same layout as ops/gram.py's
// ctypes.Structure.
struct GramProgram {
  int n_ops;
  int n_params;
  int uses_l1;
  int uses_l2;
  int op[kMaxOps];
  int metric[kMaxOps];
  int param[kMaxOps];
};

namespace {

// The leaf's value at the pair whose L1 sum is s1 and L2 sum of squares s2.
__device__ __forceinline__ float leaf(int op, int metric, float s1, float s2,
                                      const float* p) {
  const float scale = p[0];
  if (op == kExpSquared || op == kRationalQuadratic) {
    const float sq = metric == kL1 ? s1 * s1 : s2;
    const float r2 = sq / (scale * scale);
    if (op == kExpSquared) return expf(-0.5f * r2);
    const float a = p[1];
    return powf(1.0f + r2 / (2.0f * a), -a);
  }
  // L2 takes the L1 sum where the squares sum to zero, as the plain
  // version's gradient-safe branch does (kernels/distance.py).
  const float dist = metric == kL1 || s2 == 0.0f ? s1 : sqrtf(s2);
  const float r = dist / scale;
  switch (op) {
    case kExp:
      return expf(-r);
    case kMatern32: {
      const float arg = 1.7320508075688772f * r;
      return (1.0f + arg) * expf(-arg);
    }
    case kMatern52: {
      const float arg = 2.23606797749979f * r;
      return (1.0f + arg + arg * arg / 3.0f) * expf(-arg);
    }
    case kCosine:
      return cosf(6.283185307179586f * r);
    default: {  // kExpSineSquared
      const float s = sinf(3.141592653589793f * r);
      return expf(-p[1] * s * s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ x1, int n1, const float* __restrict__ x2, int n2,
                int d, const GramProgram prog, const float* __restrict__ params,
                float* __restrict__ out, long long ldo) {
  extern __shared__ float smem[];
  float* a = smem;              // [d][kTileR]: the tile's rows of X1
  float* b = smem + d * kTileR;  // [d][kTileC]: the tile's rows of X2
  __shared__ float ps[kMaxParams];

  const int tiles_c = (n2 + kTileC - 1) / kTileC;
  const int r0 = (blockIdx.x / tiles_c) * kTileR;
  const int c0 = (blockIdx.x % tiles_c) * kTileC;
  const int tid = threadIdx.x;

  for (int e = tid; e < kTileR * d; e += kThreads) {
    const int i = e / d, k = e % d;
    a[k * kTileR + i] = r0 + i < n1 ? x1[(long long)(r0 + i) * d + k] : 0.0f;
  }
  for (int e = tid; e < kTileC * d; e += kThreads) {
    const int j = e / d, k = e % d;
    b[k * kTileC + j] = c0 + j < n2 ? x2[(long long)(c0 + j) * d + k] : 0.0f;
  }
  for (int e = tid; e < prog.n_params; e += kThreads) ps[e] = params[e];
  __syncthreads();

  const int j = tid % kTileC;
  const int col = c0 + j;
  if (col >= n2) return;
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int i = tid / kTileC + t * (kThreads / kTileC);
    const int row = r0 + i;
    if (row >= n1) break;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float diff = a[k * kTileR + i] - b[k * kTileC + j];
      if (prog.uses_l1) s1 += fabsf(diff);
      if (prog.uses_l2) s2 += diff * diff;
    }
    float stack[kMaxStack];
    int sp = 0;
    for (int o = 0; o < prog.n_ops; ++o) {
      const int op = prog.op[o];
      if (op == kAdd) {
        --sp;
        stack[sp - 1] = stack[sp - 1] + stack[sp];
      } else if (op == kMul) {
        --sp;
        stack[sp - 1] = stack[sp - 1] * stack[sp];
      } else if (op == kConst) {
        stack[sp++] = ps[prog.param[o]];
      } else {
        stack[sp++] = leaf(op, prog.metric[o], s1, s2, ps + prog.param[o]);
      }
    }
    out[(long long)row * ldo + col] = stack[0];
  }
}

// Whether the program is one the kernel can run: known opcodes, parameter
// offsets inside the vector, a stack that never underflows, never passes
// kMaxStack and ends holding one value.
bool valid(const GramProgram& prog) {
  if (prog.n_ops < 1 || prog.n_ops > kMaxOps) return false;
  if (prog.n_params < 0 || prog.n_params > kMaxParams) return false;
  int sp = 0;
  for (int o = 0; o < prog.n_ops; ++o) {
    const int op = prog.op[o];
    if (op == kAdd || op == kMul) {
      if (sp < 2) return false;
      --sp;
      continue;
    }
    if (op < kConst || op > kRationalQuadratic) return false;
    const int width = (op == kExpSineSquared || op == kRationalQuadratic) ? 2 : 1;
    if (prog.param[o] < 0 || prog.param[o] + width > prog.n_params) return false;
    if (op != kConst) {
      const int m = prog.metric[o];
      const bool squared = op == kExpSquared || op == kRationalQuadratic;
      if (m != kL1 && m != kL2) return false;
      if ((m == kL1 || !squared) && !prog.uses_l1) return false;
      if (m == kL2 && !prog.uses_l2) return false;
    }
    if (++sp > kMaxStack) return false;
  }
  return sp == 1;
}

}  // namespace

extern "C" {

// B7: out[i * ldo + j] = k(x1[i], x2[j]) for i < n1, j < n2, points of d
// features, row-major float32, on `stream`. `params` is a device pointer to
// prog.n_params floats. Returns 0, cudaErrorInvalidValue for arguments the
// kernel does not take, or the launch's error.
int gram_build(const float* x1, long long n1, const float* x2, long long n2, int d,
               GramProgram prog, const float* params, float* out, long long ldo,
               void* stream) {
  if (n1 < 1 || n2 < 1 || n1 > 0x7fffffffLL || n2 > 0x7fffffffLL || d < 1 || d > kMaxD ||
      ldo < n2 || !valid(prog)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = ((n1 + kTileR - 1) / kTileR) * ((n2 + kTileC - 1) / kTileC);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)d * (kTileR + kTileC);
  gram_kernel<<<(unsigned)tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x1, (int)n1, x2, (int)n2, d, prog, params, out, ldo);
  return static_cast<int>(cudaGetLastError());
}

int gram_max_ops() { return kMaxOps; }
int gram_max_stack() { return kMaxStack; }
int gram_max_d() { return kMaxD; }

const char* gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
