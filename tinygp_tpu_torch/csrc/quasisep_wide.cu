// Kernel B3, the generic monoid scan, above order 16 on Hopper (sm_90a).
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_scan.py:
// _scan_kernel (line 331), launched by pallas_monoid_scan (line 405), for
// the Riccati flow, the affine scan (any columns) and the congruence scan
// at m = 17..32 and the coupling g' = A g B^T + C whose larger order is
// 17..32: ric_wide_kernel, aff_wide_kernel, cong_wide_kernel and
// cpl_wide_kernel, one launch and one memset of its flags a scan. The TPU
// kernel takes any order (pallas_scan.py:82-124, supports); above 32 the
// wrapper raises (ROADMAP N10). Operands and output are laid out as
// quasisep_generic.cu's, whose one-launch skeleton (mono_tile) takes the
// orders up to 16; this file is its own library so that the two build at
// once.
//
// At P = 32 a one-warp team's running value no longer fits its registers
// (a Frag<32, 32> is 32 doubles a lane; the Riccati flow's A^T, F, G alone
// would take about 192 registers) and four teams' maps no longer fit a
// block's shared memory (362 KB for the congruence, 518 KB for the Riccati
// flow). So each block takes a tile of kWideTile consecutive (for a reverse
// scan mirrored) elements by a ticket (the Riccati flow twice that), and:
//
//   a team is the block: its kWideWarps warps share every product of
//            maps on the float64 tensor cores (BlockMM: bmm, mma.sync
//            m16n8k8, each warp a share of the output's 16 x 8 tiles; the
//            Riccati merges' pivoted Gauss-Jordan elimination on the first
//            two warps, quasisep_tc.cuh: block_gj, a thread a column), the
//            maps in shared memory padded to P = 24 (m <= 24) or 32 with
//            zeros, which every product keeps; the Ops are
//            quasisep_tc.cuh's (RicOp, AffOp, CongOp, CplOp) over BlockMM;
//   streamed: a tile is not staged whole. The block copies a chunk of
//            kChunk elements' components (up to 128 bytes of each
//            component's row: the copies cost by their number, not their
//            bytes) from device memory into shared memory with cp.async,
//            16 bytes a copy where the operands' alignment allows, while
//            the last element of the chunk before is folded (or walked),
//            and puts each element into an element map in turn; the walk
//            reads the elements again. The chunk's buffer holds two of the
//            look-back's maps while the look-back runs. A tile's length,
//            and with it the look-back's merges an element, is set by what
//            a merge costs and not by what shared memory holds. Where each
//            component and each output entry sits is tabled once a block;
//   fold:    the element as a map merged after the running map (the
//            affine, congruence and coupling monoids: the merge is the
//            fold), or the rank-one step (the Riccati flow:
//            RicOp::fold_map, three products and no inverse);
//   look-back: mono_lookback's association (groups of kMonoGroup tiles
//            folded in runs of kMonoRun, the runs composed pairwise, the
//            congruence's and coupling's merges of runs compensated), each
//            merge by the whole block in turn (wide_lookback);
//   walk:    the state in shared memory, each element's application (the
//            Riccati flow: RicOp::walk_map), the state written to device
//            memory before (exclusive) or after (inclusive) each element.
//
// The Ops' merges, applications and steps are called, not inlined (w_*):
// the kernel's code and its build time stay those of one copy of each.
// Every product runs in float64 whatever the storage type, and the
// look-back composes in one fixed order, so two launches on the same inputs
// agree bit for bit; cuda_scan.plain_scan_tiled is this association (a
// tile one team) in plain PyTorch. What bounds it: bytes (as
// quasisep_generic.cu's scans) and, at P = 32, near them the float64
// tensor cores (the congruence's five products of 32 x 32 maps an element,
// fold and walk). The cost against the bound (PERF.md): a block's latency
// through each element's products and barriers and its staging, one block
// a multiprocessor at P = 32; for the Riccati flow the pivoted inverses of
// the look-back, and the chain of groups' states, an application each.

#include "quasisep_wide.cuh"

namespace {

// Where each staged component and output entry lives, in 32 bits: its slot
// in the element map or the state (bits 0..11), the operand (bits 12..13)
// and the row (bits 14..31; for the affine scan's loads and outputs the
// entry (i, j) of B as i << 5 | j, whose row is i r + col0 + j).
__device__ __forceinline__ unsigned wide_entry(int slot, int which, int row) {
  return (unsigned)slot | (unsigned)which << 12 | (unsigned)row << 14;
}

// Shared memory of a block, in bytes, and where its parts start (in Acc):
// the fold's three maps, the staged chunk's region (whose first two maps
// are the look-back's maps 3 and 4), the merges' scratch, two states, the
// Riccati step's vectors, then the components' and outputs' tables.
template <class Op, typename S>
struct WideSmem {
  static constexpr int P = Op::H * 8;
  static constexpr int kTabBytes = (Op::kMaxComps + P * P) * (int)sizeof(unsigned);
  static constexpr long long kMapBytes = (long long)Op::kMap * sizeof(Acc);
  static constexpr long long kFixed =
      (kWideFoldMaps * Op::kMap + Op::kScratch + 2 * Op::kState + 4 * P + 4) * (long long)sizeof(Acc) +
      kTabBytes;
  static constexpr long long kPer = (long long)Op::kMaxComps * sizeof(S);
  static constexpr int kChunk = wide_chunk(kFixed, kPer, kMapBytes, 128 / (int)sizeof(S));
  static constexpr long long kRegion = wide_region(kPer, kMapBytes, kChunk);
  static constexpr int kScr = (int)((kWideFoldMaps * kMapBytes + kRegion) / sizeof(Acc)),
                       kSt = kScr + Op::kScratch, kS = kSt + Op::kState, kVec = kS + Op::kState,
                       kTab = kVec + 4 * P + 4;
  static constexpr long long kBytes = kFixed + kRegion;
  static_assert(kBytes <= kGenSharedBlock && kWideMaps == kWideFoldMaps + 2, "the layout");
};

// One tile of a scan above order 16 (the design above): the ticket, the
// fold of the streamed elements, the look-back, the walk.
template <class Op, typename S>
__device__ __forceinline__ void wide_tile(Op op, long long n, int r, int reverse, int inclusive,
                                          int groups, int cols, GIn<S> in, S* out, Acc* work,
                                          const ChainLayout& lay) {
  using L = WideSmem<Op, S>;
  constexpr int MAP = Op::kMap, E = L::kChunk, LE = wide_log2(E);
  const int m = op.m, t = threadIdx.x;
  __shared__ long long ticket_of_block;
  Acc* maps = reinterpret_cast<Acc*>(qsl_smem);
  Acc* scr = maps + L::kScr;
  Acc* st = maps + L::kSt;
  Acc* s = maps + L::kS;
  Acc* vec = maps + L::kVec;
  unsigned* tab = reinterpret_cast<unsigned*>(maps + L::kTab);
  unsigned* otab = tab + Op::kMaxComps;
  // The staged chunk: component c, element e at raw[c E + e] (e in the
  // operands' memory order: reversed in a reverse scan).
  S* raw = reinterpret_cast<S*>(maps + kWideFoldMaps * MAP);

  if (t == 0) ticket_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  constexpr int T = wide_tile_len(Op::kKind);
  const long long b = ticket_of_block / groups, p0 = b * T;
  const int grp = (int)(ticket_of_block % groups), col0 = grp * cols;
  if constexpr (Op::kKind == gAff) op.cols = min(cols, r - col0);
  const int comps = Op::comps(m, op.cols), rows = op.out_rows();
  const int cnt = (int)(n - p0 < T ? n - p0 : T);
  const auto pos = [&](int i) { return reverse ? n - 1 - p0 - i : p0 + i; };
  // A table entry's row of the output or of its operand.
  const auto row_of = [&](unsigned e) {
    const int code = (int)(e >> 14);
    return Op::kKind == gAff && ((e >> 12) & 3) ? (code >> 5) * r + col0 + (code & 31) : code;
  };

  for (int c = t; c < comps; c += kWideThreads) {
    int which = 0, row = c;
    if constexpr (Op::kKind == gAff) {
      if (c >= m * m) which = 1, row = (c - m * m) / op.cols << 5 | (c - m * m) % op.cols;
    } else if constexpr (Op::kKind == gCong) {
      if (c >= m * m) which = 1, row = c - m * m;
    } else if constexpr (Op::kKind == gCpl) {
      const int ob = m * m, oc = ob + op.cols * op.cols;
      if (c >= oc) which = 2, row = c - oc;
      else if (c >= ob) which = 1, row = c - ob;
    } else {
      which = c == 0 ? 0 : c <= m ? 1 : c <= 2 * m ? 2 : 3;
      row = c == 0 ? 0 : c <= m ? c - 1 : c <= 2 * m ? c - 1 - m : c - 1 - 2 * m;
    }
    tab[c] = wide_entry(op.el_slot(c), which, row);
  }
  for (int q = t; q < rows; q += kWideThreads)
    otab[q] = wide_entry(op.state_slot(q), Op::kKind == gAff,
                         Op::kKind == gAff ? q / op.cols << 5 | q % op.cols : q);
  __syncthreads();
  // The chunk of elements [k E, k E + E) into raw, by cp.async: a full
  // chunk 16 bytes a copy where every operand allows it, a warp's 32 copies
  // covering 32 / V components' runs of E elements; otherwise an element a
  // copy, 32 / E runs a warp.
  constexpr int V = E * (int)sizeof(S) / 16, W = 16 / (int)sizeof(S);  // copies a run, elements a copy
  const bool by16 = V > 0 && (n * (long long)sizeof(S)) % 16 == 0 && aligned16(in.x0) &&
                    aligned16(in.x1) && aligned16(in.x2) && aligned16(in.x3);
  const auto src_of = [&](unsigned en) {
    const int which = (en >> 12) & 3;
    return (which == 0 ? in.x0 : which == 1 ? in.x1 : which == 2 ? in.x2 : in.x3) +
           (long long)row_of(en) * n;
  };
  const auto fetch = [&](int k) {
    const int e0 = k * E;
    if (by16 && e0 + E <= cnt) {
      const long long lo = reverse ? n - p0 - e0 - E : p0 + e0;
      for (int idx = t; idx < comps * V; idx += kWideThreads) {
        const int c = idx / V, v = idx - c * V;
        cp_async16(raw + c * E + v * W, src_of(tab[c]) + lo + v * W);
      }
    } else {
      for (int idx = t; idx < comps * E; idx += kWideThreads) {
        const int c = idx >> LE, e = idx & (E - 1);
        if (e0 + e < cnt)
          cp_async_elem(raw + c * E + (reverse ? E - 1 - e : e), src_of(tab[c]) + pos(e0 + e));
      }
    }
    cp_async_commit();
  };
  // Element jj into the element map el (its padding stays 0); once its
  // chunk is used up, raw takes the next chunk.
  const auto stage = [&](Acc* el, int jj) {
    const int e = jj & (E - 1), at = reverse ? E - 1 - e : e;
    if (e == 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    for (int c = t; c < comps; c += kWideThreads) el[tab[c] & 0xfff] = Acc(raw[c * E + at]);
    __syncthreads();
    if (e == E - 1 && jj + 1 < cnt) fetch((jj + 1) >> LE);
  };
  const auto put = [&](const Acc* x, int i) {
    const long long at = pos(i);
    for (int q = t; q < rows; q += kWideThreads) {
      const unsigned en = otab[q];
      out[(long long)row_of(en) * n + at] = S(x[en & 0xfff]);
    }
  };
  const auto zero = [&](Acc* x) {
    for (int c = t; c < MAP; c += kWideThreads) x[c] = Acc(0);
    __syncthreads();
  };

  // The fold: maps 0 and 1 the running map, 2 the element.
  int cur = 0, nxt = 1;
  Acc* el = maps + 2 * MAP;
  zero(el);
  Op::identity_map(maps);
  fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    stage(el, jj);
    w_fold(op, maps + cur * MAP, el, maps + nxt * MAP, scr, vec);
    const int swap = cur;
    cur = nxt;
    nxt = swap;
  }

  wide_lookback(op, b, lay.nt, lay.slots(work, grp, MAP), maps, cur, scr, st, s);

  // The walk from the tile's start in st.
  el = maps + nxt * MAP;
  zero(el);
  fetch(0);
  for (int jj = 0; jj < cnt; ++jj) {
    stage(el, jj);
    if (!inclusive) put(st, jj);
    w_walk(op, st, el, scr, vec);
    if (inclusive) put(st, jj);
  }
}

// B3's Riccati flow above m = 16 (padded to P), exclusive: (d, ps, qs, as_)
// in, F (m^2, n) out.
template <int P, typename S>
__global__ void __launch_bounds__(kWideThreads)
ric_wide_kernel(int m, long long n, GIn<S> in, S* out, Acc* work, ChainLayout lay) {
  RicOp<P, BlockMM> op;
  op.m = m;
  wide_tile(op, n, 1, 0, 0, 1, 1, in, out, work, lay);
}

// B3's affine scan above m = 16, r columns in groups of RC, forward or
// reverse, exclusive or inclusive: (A, B) in, (m r, n) out.
template <int P, int RC, typename S>
__global__ void __launch_bounds__(kWideThreads)
aff_wide_kernel(int m, long long n, int r, int reverse, int inclusive, int groups, GIn<S> in,
                S* out, Acc* work, ChainLayout lay) {
  AffOp<P, RC, BlockMM> op;
  op.m = m;
  op.cols = RC;
  wide_tile(op, n, r, reverse, inclusive, groups, RC, in, out, work, lay);
}

// B3's congruence scan above m = 16: (A, B) in, (m^2, n) out.
template <int P, typename S>
__global__ void __launch_bounds__(kWideThreads)
cong_wide_kernel(int m, long long n, int reverse, int inclusive, GIn<S> in, S* out, Acc* work,
                 ChainLayout lay) {
  CongOp<P, true, BlockMM> op;
  op.m = m;
  wide_tile(op, n, 1, reverse, inclusive, 1, 1, in, out, work, lay);
}

// B3's coupling whose larger order is above 16: (A, B, C) in, (m m2, n)
// out.
template <int P, typename S>
__global__ void __launch_bounds__(kWideThreads)
cpl_wide_kernel(int m, int m2, long long n, int reverse, int inclusive, GIn<S> in, S* out,
                Acc* work, ChainLayout lay) {
  CplOp<P, true, BlockMM> op;
  op.m = m;
  op.cols = m2;
  wide_tile(op, n, 1, reverse, inclusive, 1, 1, in, out, work, lay);
}

// A scan's plan: padded order, columns a group, groups, its maps' and
// states' sizes and its shared memory (in bytes) for operands of `bytes`.
struct WidePlan {
  int P, rc, groups, map, state;
  long long smem;
};

template <class Op>
inline void wide_fill(WidePlan& p, int bytes) {
  p.map = Op::kMap;
  p.state = Op::kState;
  p.smem = bytes == 4 ? WideSmem<Op, float>::kBytes : WideSmem<Op, double>::kBytes;
}

inline bool wide_takes(const GSpec& s) {
  return (s.kind == gCpl && s.m2 > s.m ? s.m2 : s.m) >= kWideMinM;
}

inline WidePlan wide_plan(const GSpec& s, int bytes) {
  WidePlan p;
  const int big = s.kind == gCpl && s.m2 > s.m ? s.m2 : s.m;
  p.P = big <= 24 ? 24 : 32;
  p.rc = s.kind == gAff ? kWideCols : 1;
  p.groups = (s.r + p.rc - 1) / p.rc;
  const bool p24 = p.P == 24;
  if (s.kind == gRic) {
    if (p24) wide_fill<RicOp<24, BlockMM>>(p, bytes);
    else wide_fill<RicOp<32, BlockMM>>(p, bytes);
  } else if (s.kind == gCong) {
    if (p24) wide_fill<CongOp<24, true, BlockMM>>(p, bytes);
    else wide_fill<CongOp<32, true, BlockMM>>(p, bytes);
  } else if (s.kind == gCpl) {
    if (p24) wide_fill<CplOp<24, true, BlockMM>>(p, bytes);
    else wide_fill<CplOp<32, true, BlockMM>>(p, bytes);
  } else {
    if (p24) wide_fill<AffOp<24, kWideCols, BlockMM>>(p, bytes);
    else wide_fill<AffOp<32, kWideCols, BlockMM>>(p, bytes);
  }
  return p;
}

// The look-back's workspace (the same for either storage type).
inline ChainLayout wide_layout(const GSpec& s, long long n) {
  const WidePlan p = wide_plan(s, 8);
  const int tile = wide_tile_len(s.kind);
  return ChainLayout((n + tile - 1) / tile, p.groups, p.map, p.state, kMonoGroup);
}

// One memset (the ticket and the flags) and one launch, on stream st.
template <typename S>
cudaError_t wide_run(const GSpec& s, long long n, int reverse, int inclusive, const GIn<S>& in,
                     S* out, Acc* work, const ChainLayout& lay, cudaStream_t st) {
  const WidePlan p = wide_plan(s, (int)sizeof(S));
  if (p.smem > kGenSharedBlock || lay.nt * p.groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(work + lay.flags, 0, lay.flag_words * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(lay.nt * p.groups));
  const bool p24 = p.P == 24;
  const int th = kWideThreads;
  if (s.kind == gRic)
    return p24 ? g_launch(ric_wide_kernel<24, S>, grid, th, p.smem, st, s.m, n, in, out, work, lay)
               : g_launch(ric_wide_kernel<32, S>, grid, th, p.smem, st, s.m, n, in, out, work, lay);
  if (s.kind == gCong)
    return p24 ? g_launch(cong_wide_kernel<24, S>, grid, th, p.smem, st, s.m, n, reverse,
                          inclusive, in, out, work, lay)
               : g_launch(cong_wide_kernel<32, S>, grid, th, p.smem, st, s.m, n, reverse,
                          inclusive, in, out, work, lay);
  if (s.kind == gCpl)
    return p24 ? g_launch(cpl_wide_kernel<24, S>, grid, th, p.smem, st, s.m, s.m2, n, reverse,
                          inclusive, in, out, work, lay)
               : g_launch(cpl_wide_kernel<32, S>, grid, th, p.smem, st, s.m, s.m2, n, reverse,
                          inclusive, in, out, work, lay);
  return p24 ? g_launch(aff_wide_kernel<24, kWideCols, S>, grid, th, p.smem, st, s.m, n, s.r,
                        reverse, inclusive, p.groups, in, out, work, lay)
             : g_launch(aff_wide_kernel<32, kWideCols, S>, grid, th, p.smem, st, s.m, n, s.r,
                        reverse, inclusive, p.groups, in, out, work, lay);
}

template <typename S>
int scan(int kind, int m, int m2, long long n, int r, int reverse, int inclusive,
         const S* x0, const S* x1, const S* x2, const S* x3, S* out, Acc* work,
         long long work_elems, void* stream) {
  if (!g_valid(kind, m, m2, n, r)) return (int)cudaErrorInvalidValue;
  const GSpec s = g_spec(kind, m, m2, r);
  if (!wide_takes(s) || work_elems < wide_layout(s, n).total) return (int)cudaErrorInvalidValue;
  return (int)wide_run<S>(s, n, reverse, inclusive, GIn<S>{x0, x1, x2, x3}, out, work,
                          wide_layout(s, n), static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Workspace of a scan, in float64 elements; -1 for what this source does
// not take (orders up to 16). kind: 0 affine, 1 congruence, 2 Riccati, 3
// coupling; m2 is the coupling's second order (m for the other kinds); r
// the affine columns.
long long qsw_workspace_elems(int kind, int m, int m2, long long n, int r) {
  if (!g_valid(kind, m, m2, n, r) || !wide_takes(g_spec(kind, m, m2, r))) return -1;
  return wide_layout(g_spec(kind, m, m2, r), n).total;
}

// A scan's association for operands of `bytes` bytes: elements per tile
// and per team (one team, the tile) and affine columns per group into
// tile[0], sub[0], cols[0]; returns 0, or -1 where this source does not
// take the scan.
int qsw_schedule(int kind, int m, int m2, int r, int bytes, int* tile, int* sub, int* cols) {
  if (!g_valid(kind, m, m2, 1, r) || !wide_takes(g_spec(kind, m, m2, r)) ||
      (bytes != 4 && bytes != 8))
    return -1;
  *tile = *sub = wide_tile_len(kind);
  *cols = wide_plan(g_spec(kind, m, m2, r), bytes).rc;
  return 0;
}

// One scan into out, as quasisep_generic.cu's qsg_scan_*. Returns a
// cudaError_t code: nonzero if an argument is refused or a launch failed.
int qsw_scan_f32(int kind, int m, int m2, long long n, int r, int reverse, int inclusive,
                 const float* x0, const float* x1, const float* x2, const float* x3, float* out,
                 double* work, long long work_elems, void* stream) {
  return scan<float>(kind, m, m2, n, r, reverse, inclusive, x0, x1, x2, x3, out, work,
                     work_elems, stream);
}

int qsw_scan_f64(int kind, int m, int m2, long long n, int r, int reverse, int inclusive,
                 const double* x0, const double* x1, const double* x2, const double* x3,
                 double* out, double* work, long long work_elems, void* stream) {
  return scan<double>(kind, m, m2, n, r, reverse, inclusive, x0, x1, x2, x3, out, work,
                      work_elems, stream);
}

const char* qsw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
