// The generic-order sources' shared pieces on Hopper (sm_90a): a scan's
// monoid and shape (GSpec, g_spec, g_valid), its operands (GIn), the
// components of a monoid value (g_size), the team-cooperative merge of
// two affine or congruence values (g_combine, for quasisep_loglik_generic.cu:
// b2_warp_kernel) and the launch helper (g_launch). Included by
// quasisep_tc.cuh, and so by quasisep_generic.cu, quasisep_wide.cu,
// quasisep_loglik_generic.cu and quasisep_loglik_wide.cu. Every scan of
// kernels B1, B1r, B2 and B3 above the templated orders is one launch and
// one memset (those files); no multi-pass engine remains.

#pragma once

#include "quasisep_common.cuh"

namespace {

enum GKind { gAff = 0, gCong = 1, gRic = 2, gCpl = 3 };

constexpr int kGenMaxM = 32;                   // largest order the generic sources take
constexpr long long kGenSharedBlock = 232448;  // 227 KB, a block on sm_90
constexpr long long kGenSharedSM = 233472;     // 228 KB per multiprocessor

// One scan's monoid and order: m2 is the coupling's second order (m for the
// other monoids), r the affine scan's columns (1 for the other monoids).
struct GSpec {
  int kind, m, m2, r;
};

template <typename S>
struct GIn {
  const S* x0;
  const S* x1;
  const S* x2;
  const S* x3;
};

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

// out = combine(e, l) of the affine or congruence monoid: the earlier value
// e, then the later l, by a team (quasisep_common.cuh: gmm). out aliases
// neither. scr: m^2 values (the congruence's product). M > 0 is s.m as a
// compile-time constant.
template <int M, class Team>
__device__ void g_combine(const Team& tm, const GSpec& s, int c, const Acc* e, const Acc* l,
                          Acc* out, Acc* scr) {
  const int m = M > 0 ? M : s.m, mm = m * m;
  if (s.kind == gAff) {
    // (A_l A_e, A_l B_e + B_l)
    gmm(tm, m, m, m, l, m, false, e, m, false, out, m);
    gmm(tm, m, m, c, l, m, false, e + mm, c, false, out + mm, c, l + mm, c);
  } else {
    // (A_l A_e, A_l B_e A_l^T + B_l)
    gmm(tm, m, m, m, l, m, false, e, m, false, out, m);
    gmm(tm, m, m, m, l, m, false, e + mm, m, false, scr, m);
    gmm(tm, m, m, m, scr, m, false, l, m, true, out + mm, m, l + mm, m);
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

// The scan's monoid and shape.
inline GSpec g_spec(int kind, int m, int m2, int r) {
  return GSpec{kind, m, kind == gCpl ? m2 : m, kind == gAff ? r : 1};
}

// A scan the generic sources take (the Riccati flow from m = 2).
inline bool g_valid(int kind, int m, int m2, long long n, int r) {
  return kind >= gAff && kind <= gCpl && m >= 1 && m <= kGenMaxM && m2 >= 1 &&
         m2 <= kGenMaxM && n >= 1 && r >= 1 && r <= 65535 &&
         (kind == gAff || r == 1) && (kind == gCpl || m2 == m) &&
         (kind != gRic || m >= 2);
}

}  // namespace
