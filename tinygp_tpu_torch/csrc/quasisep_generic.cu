// Kernel B3, the generic monoid scan, at every order on Hopper (sm_90a).
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_scan.py:
// _scan_kernel (line 331), launched by pallas_monoid_scan (line 405), for
// the orders quasisep_scan.cu's templates do not take: the affine,
// congruence and Riccati monoids with 4 < m <= 32 and the coupling of any
// pair of orders up to 32 other than two equal orders up to 4. The TPU
// kernel takes any order (pallas_scan.py:82-124, supports); the JAX
// package sends every monoid with combine_lists to it (scan.py:195-201).
//
// The engine is quasisep_generic.cuh's; this file is its C interface. The
// operands and the output are laid out as quasisep_scan.cu's: stacked, a
// (k, n) operand holding component c of element j at [c * n + j], in
// float32 or float64; the affine loads B and states (m * r, n) with row
// i * r + col; the Riccati flow reads (d, ps, qs, as) and forms its
// Moebius map in the kernel; the coupling reads A (m * m, n), B (m2 * m2, n)
// and C (m * m2, n) and writes C's leaf, (m * m2, n).

#include "quasisep_generic.cuh"

namespace {

template <typename S>
int scan(int kind, int m, int m2, long long n, int r, int reverse, int inclusive,
         const S* x0, const S* x1, const S* x2, const S* x3, S* out, Acc* work,
         long long work_elems, void* stream) {
  if (!g_valid(kind, m, m2, n, r)) return (int)cudaErrorInvalidValue;
  const GSpec s = g_spec(kind, m, m2, r);
  if (work_elems < g_workspace_elems(s, n)) return (int)cudaErrorInvalidValue;
  return (int)g_run<S, S>(s, n, reverse, inclusive, GIn<S>{x0, x1, x2, x3}, out,
                          work, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Workspace of a scan, in float64 elements; -1 for what the engine does not
// take. kind: 0 affine, 1 congruence, 2 Riccati, 3 coupling; m2 is the
// coupling's second order (m for the other kinds); r the affine columns.
long long qsg_workspace_elems(int kind, int m, int m2, long long n, int r) {
  if (!g_valid(kind, m, m2, n, r)) return -1;
  return g_workspace_elems(g_spec(kind, m, m2, r), n);
}

// One scan into out. Operands by kind: affine (A, B), congruence (A, B),
// Riccati (d, ps, qs, as), coupling (A, B, C); unused pointers are null.
// Returns a cudaError_t code: nonzero if an argument is refused or a
// launch failed.
int qsg_scan_f32(int kind, int m, int m2, long long n, int r, int reverse,
                 int inclusive, const float* x0, const float* x1,
                 const float* x2, const float* x3, float* out, double* work,
                 long long work_elems, void* stream) {
  return scan<float>(kind, m, m2, n, r, reverse, inclusive, x0, x1, x2, x3, out,
                     work, work_elems, stream);
}

int qsg_scan_f64(int kind, int m, int m2, long long n, int r, int reverse,
                 int inclusive, const double* x0, const double* x1,
                 const double* x2, const double* x3, double* out, double* work,
                 long long work_elems, void* stream) {
  return scan<double>(kind, m, m2, n, r, reverse, inclusive, x0, x1, x2, x3,
                      out, work, work_elems, stream);
}

const char* qsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
