// The generic monoid scan of the quasiseparable algebra on Hopper (sm_90a):
// kernel B3 at m = 1..4.
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_scan.py:
// _scan_kernel (line 331), launched by pallas_monoid_scan (line 405,
// pallas_call at line 518): an exclusive scan along n of a monoid whose
// combine is given component by component, forward or reverse, writing only
// the leaves the caller consumes. Here the monoid is a template parameter,
// instantiated for the four monoids of the O(N) algebra:
//
//   Aff<m, C>   g' = A g + B, C columns    [A | B],      m^2 + m C components
//   Cong<m>     g' = A g A^T + B           [A | B],      2 m^2
//   Ric<m>      the Riccati covariance flow as a Moebius map
//               (quasisep_common.cuh)      [A | F | G],  3 m^2
//   Cpl<m,m>    g' = A g B^T + C           [A | B | C],  3 m^2
//
// for m = 1..4 (the coupling of two equal orders; every other coupling up
// to order 8 is quasisep_generic.cu's one-launch kernel). Each runs forward
// or reverse, exclusive or inclusive, and writes one leaf: B of the affine
// and congruence scans (the state, which starts at 0), F of the Riccati
// flow, C of the coupling.
//
// Operands are stacked as in the JAX package: a (k, n) operand holds
// component c of element j at [c * n + j], row-major and contiguous, in
// float32 or float64. The affine loads B and states are (m * r, n), row
// i * r + col; the Riccati flow reads the element's (d, p, q, a), (n),
// (m, n), (m, n), (m * m, n).
//
// Precision. Every combine and step runs in float64 (Acc) whatever the
// operands' type, as in B1 (see quasisep_loglik.cu): composed in float32,
// the Riccati maps of long spans lose the state. The output is stored in
// the operands' type.
//
// What bounds it: bytes. The sequential recurrence reads each operand once
// and writes the state once: an affine scan with m = 2, r = 1 moves 8
// values per element (32 bytes in float32, 9.6 us at n = 1e6 at 3.35 TB/s)
// for 8 flops (0.12 us at 67 TFLOP/s); the Riccati flow, m = 2, reads 9 and
// writes 4 values for about 60 flops.
//
// Design: one launch (b3_tile_kernel) and one memset of its flags per
// call, B1's design (quasisep_loglik.cu) made generic over the monoid. The
// TPU grid runs in order and carries the prefix from one grid step to the
// next in VMEM (pallas_scan.py:11-24); here each block takes a tile of
// kTileThreads * sub consecutive positions by a ticket (quasisep_common.cuh:
// the one-launch look-back), and thread t owns the sub positions
// t * sub .. t * sub + sub - 1 of it.
//
//   staging: every operand's run for the tile is contiguous, so the block
//            copies each component once, coalesced, with cp.async into
//            shared memory (thread t's element jj at slot jj * kTileThreads
//            + t, so that the threads' reads are conflict-free); nothing
//            is read from device memory again.
//   fold:    each thread folds its elements into one monoid value: the
//            affine, congruence and coupling maps with their combine, the
//            Riccati flow with the rank-one step (no inverse, as B1).
//   scan:    a warp-shuffle scan gives each thread its exclusive prefix and
//            the tile its aggregate; the tile publishes it, and the
//            look-back (its group fold a Kogge-Stone scan over a warp's
//            lanes, as B1's) gives the state at the tile's start.
//   walk:    each thread applies its prefix to the tile's start and walks
//            its elements with the sequential step (A s + B, A s A^T + B,
//            A g B^T + C, the Riccati F' = a F a^T + u u^T / c2), putting
//            the state before (exclusive) or after (inclusive) each
//            element over its staged inputs; the block then writes the
//            states out coalesced.
//
// Affine columns. The r columns of an affine scan share the transitions.
// A block takes a group of kAffCols columns of one tile (the ticket runs
// over tiles, then groups: ticket = tile * groups + group), so a group's
// columns share one staging, fold and scan of A, and a column group is a
// chain of tiles of its own. Columns inside a tile and not on the grid:
// the groups of one tile run in parallel, and at n = 1e5 (196 tiles, one
// wave) a call is one tile's latency whatever r; a whole tile of 16
// columns would serialise them in one block. One column (B1's and the
// solves' shape) is its own instantiation, so that its values stay m^2 + m
// wide.
//
// A reverse scan mirrors the index (position j holds element n - 1 - j), as
// B2 does, so the forward combine serves both directions: the suffix
// composition of elements k < l is combine(element l, element k). The
// ragged last tile is masked; nothing is padded (the TPU launcher pads with
// identities). The look-back folds and applies in one fixed order whichever
// tiles it finds published, so two launches on the same inputs agree bit
// for bit; cuda_scan.plain_scan_tiled is this association in plain
// PyTorch. The cost against the bound: float64 arithmetic, and the latency
// of a tile's staging, two walks over its elements, one in-tile scan and
// one look-back.

#include "quasisep_common.cuh"

namespace {

enum Kind { kAff = 0, kCong = 1, kRic = 2, kCpl = 3 };

constexpr int kAffCols = 8;  // affine columns a block takes (r > 1)

// Elements per thread for a tile of `in_bytes` staged bytes an element:
// the largest of 8, 4, 2 that keeps the staged tile within 64 KB.
// cuda_scan.b3_schedule repeats it.
__host__ __device__ constexpr int b3_sub(int in_bytes) {
  return in_bytes <= 128 ? 8 : in_bytes <= 256 ? 4 : 2;
}

// ---------------------------------------------------------------- two monoids

// The congruence recurrence g' = A g A^T + B, flattened [A | B].
template <typename T, int M>
struct Cong {
  static constexpr int MM = M * M;
  static constexpr int S = 2 * MM;
  T v[S];

  __device__ static Cong identity() {
    Cong r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < MM && c % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // (A_l A_e, A_l B_e A_l^T + B_l)
  __device__ static Cong combine(const Cong& e, const Cong& l) {
    Cong out;
    T t[MM], u[MM];
    mm<T, M>(l.v, e.v, out.v);
    mm<T, M>(l.v, e.v + MM, t);
    mm_nt<T, M>(t, l.v, u);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[MM + c] = u[c] + l.v[MM + c];
    return out;
  }
};

// The two-sided coupling g' = A g B^T + C with g of shape (M, M),
// flattened [A | B | C].
template <typename T, int M>
struct Cpl {
  static constexpr int MM = M * M;
  static constexpr int S = 3 * MM;
  T v[S];

  __device__ static Cpl identity() {
    Cpl r;
#pragma unroll
    for (int c = 0; c < S; ++c) r.v[c] = (c < 2 * MM && c % MM % (M + 1) == 0) ? T(1) : T(0);
    return r;
  }

  // (A_l A_e, B_l B_e, A_l C_e B_l^T + C_l)
  __device__ static Cpl combine(const Cpl& e, const Cpl& l) {
    Cpl out;
    T t[MM], u[MM];
    mm<T, M>(l.v, e.v, out.v);
    mm<T, M>(l.v + MM, e.v + MM, out.v + MM);
    mm<T, M>(l.v, e.v + 2 * MM, t);
    mm_nt<T, M>(t, l.v + MM, u);
#pragma unroll
    for (int c = 0; c < MM; ++c) out.v[2 * MM + c] = u[c] + l.v[2 * MM + c];
    return out;
  }
};

// ------------------------------------------------- operands of each monoid
//
// An op names the operand row of each staged component and the output row
// of each state entry, reads one staged element (elem), folds it into the
// running value (fold), steps the state through it (step) and applies a
// map to a state (apply: the look-back and each thread's start). IN
// components are staged an element, and the state has SZ entries, IN >= SZ:
// the walk puts an element's state over its staged inputs.

// A staged element of a linear monoid: its map.
template <class V, int LD, typename S>
__device__ __forceinline__ V staged_map(const S* col) {
  V x;
#pragma unroll
  for (int c = 0; c < V::S; ++c) x.v[c] = Acc(col[c * LD]);
  return x;
}

template <typename S_, int M, int C>
struct AffOp {
  using S = S_;
  using V = Aff<Acc, M, C>;
  static constexpr int MM = M * M, IN = V::S, SZ = M * C;
  const S* A;
  const S* B;
  S* out;
  int r;

  // Component c of the group's operands, null for a column past r.
  __device__ const S* src(int c, int grp, long long n) const {
    if (c < MM) return A + c * n;
    const int i = (c - MM) / C, col = grp * C + (c - MM) % C;
    return col < r ? B + ((long long)i * r + col) * n : nullptr;
  }
  __device__ S* dst(int c, int grp, long long n) const {
    const int i = c / C, col = grp * C + c % C;
    return col < r ? out + ((long long)i * r + col) * n : nullptr;
  }
  template <int LD>
  __device__ V elem(const S* col) const { return staged_map<V, LD>(col); }
  __device__ static void fold(V& acc, const V& x) { acc = V::combine(acc, x); }
  __device__ static void step(const V& x, Acc* s) { aff_apply<M, C>(x.v, s); }
  __device__ static void apply(const Acc* map, Acc* s) { aff_apply<M, C>(map, s); }
};

// s <- A s A^T + B; map = [A | B].
template <int M>
__device__ __forceinline__ void cong_apply(const Acc* map, Acc* s) {
  Acc t[M * M], u[M * M];
  mm<Acc, M>(map, s, t);
  mm_nt<Acc, M>(t, map, u);
#pragma unroll
  for (int c = 0; c < M * M; ++c) s[c] = u[c] + map[M * M + c];
}

// g <- A g B^T + C; map = [A | B | C].
template <int M>
__device__ __forceinline__ void cpl_apply(const Acc* map, Acc* g) {
  Acc t[M * M], u[M * M];
  mm<Acc, M>(map, g, t);
  mm_nt<Acc, M>(t, map + M * M, u);
#pragma unroll
  for (int c = 0; c < M * M; ++c) g[c] = u[c] + map[2 * M * M + c];
}

template <typename S_, int M>
struct CongOp {
  using S = S_;
  using V = Cong<Acc, M>;
  static constexpr int MM = M * M, IN = V::S, SZ = MM;
  const S* A;
  const S* B;
  S* out;

  __device__ const S* src(int c, int, long long n) const { return c < MM ? A + c * n : B + (c - MM) * n; }
  __device__ S* dst(int c, int, long long n) const { return out + c * n; }
  template <int LD>
  __device__ V elem(const S* col) const { return staged_map<V, LD>(col); }
  __device__ static void fold(V& acc, const V& x) { acc = V::combine(acc, x); }
  __device__ static void step(const V& x, Acc* s) { cong_apply<M>(x.v, s); }
  __device__ static void apply(const Acc* map, Acc* s) { cong_apply<M>(map, s); }
};

template <typename S_, int M>
struct CplOp {
  using S = S_;
  using V = Cpl<Acc, M>;
  static constexpr int MM = M * M, IN = V::S, SZ = MM;
  const S* A;
  const S* B;
  const S* C;
  S* out;

  __device__ const S* src(int c, int, long long n) const {
    return c < MM ? A + c * n : c < 2 * MM ? B + (c - MM) * n : C + (c - 2 * MM) * n;
  }
  __device__ S* dst(int c, int, long long n) const { return out + c * n; }
  template <int LD>
  __device__ V elem(const S* col) const { return staged_map<V, LD>(col); }
  __device__ static void fold(V& acc, const V& x) { acc = V::combine(acc, x); }
  __device__ static void step(const V& x, Acc* s) { cpl_apply<M>(x.v, s); }
  __device__ static void apply(const Acc* map, Acc* s) { cpl_apply<M>(map, s); }
};

// The Riccati flow from the element's (d, p, q, a), staged [d | p | q | a]:
// folded into its Moebius map with the rank-one step, stepped with the
// sequential recurrence, the map applied to F by the Moebius action.
template <typename S_, int M>
struct RicOp {
  using S = S_;
  using V = Ric<Acc, M>;
  static constexpr int MM = M * M, IN = 1 + 2 * M + MM, SZ = MM;
  const S* d;
  const S* ps;
  const S* qs;
  const S* as;
  S* out;

  __device__ const S* src(int c, int, long long n) const {
    return c == 0 ? d : c <= M ? ps + (c - 1) * n : c <= 2 * M ? qs + (c - 1 - M) * n
                                                               : as + (c - 1 - 2 * M) * n;
  }
  __device__ S* dst(int c, int, long long n) const { return out + c * n; }
  template <int LD>
  __device__ RicElem<M> elem(const S* col) const {
    RicElem<M> el;
    el.d = Acc(col[0]);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      el.p[i] = Acc(col[(1 + i) * LD]);
      el.q[i] = Acc(col[(1 + M + i) * LD]);
    }
#pragma unroll
    for (int c = 0; c < MM; ++c) el.a[c] = Acc(col[(1 + 2 * M + c) * LD]);
    return el;
  }
  __device__ static void fold(V& acc, const RicElem<M>& el) { el.fold(acc); }
  __device__ static void step(const RicElem<M>& el, Acc* F) {
    Acc u[M];
    const Acc c2 = el.emit(F, u);
    el.advance(F, u, c2);
  }
  __device__ static void apply(const Acc* map, Acc* F) { ric_apply<M>(map, F); }
};

template <class Op>
__host__ __device__ constexpr int op_sub() {
  return b3_sub(Op::IN * (int)sizeof(typename Op::S));
}

// Shared memory of a block, in bytes: the look-back window, the scan's warp
// total, the tile's aggregate and the state at the tile's start (all Acc),
// then the staged tile.
template <class Op>
constexpr long long b3_smem() {
  using V = typename Op::V;
  constexpr int T = kTileThreads * op_sub<Op>();
  return (long long)((kLookWindow + 2) * V::S + Op::SZ) * sizeof(Acc) +
         (long long)Op::IN * (T + 1) * sizeof(typename Op::S);
}

// ------------------------------------------------------------------- kernel

template <class Op>
__global__ void __launch_bounds__(kTileThreads)
b3_tile_kernel(Op op, long long n, int reverse, int inclusive, int groups, Acc* work,
               ChainLayout lay) {
  using V = typename Op::V;
  using S = typename Op::S;
  constexpr int SUB = op_sub<Op>(), T = kTileThreads * SUB, LD = T + 1, SZ = Op::SZ;
  __shared__ long long ticket_of_block;
  Acc* win = reinterpret_cast<Acc*>(qsl_smem);
  Acc* scan_sm = win + kLookWindow * V::S;
  Acc* agg = scan_sm + V::S;
  Acc* start = agg + V::S;
  S* st = reinterpret_cast<S*>(start + SZ);
  const int t = threadIdx.x, warp = t >> 5;

  if (t == 0) ticket_of_block = atomicAdd(lay.ticket(work), 1u);
  __syncthreads();
  const long long b = ticket_of_block / groups, p0 = b * T;
  const int grp = (int)(ticket_of_block % groups);
  const int cnt = (int)(n - p0 < T ? n - p0 : T);
  // Staged slot of position i of the tile.
  const auto slot = [](int i) { return (i % SUB) * kTileThreads + i / SUB; };

  // Stage the tile: position i (element p0 + i, or n - 1 - p0 - i) of
  // component c at st[c * LD + slot(i)]; a column past r is zero.
  for (int c = 0; c < Op::IN; ++c) {
    const S* src = op.src(c, grp, n);
    S* row = st + c * LD;
    if (!src) {
      for (int i = t; i < cnt; i += kTileThreads) row[slot(i)] = S(0);
      continue;
    }
    src += reverse ? n - 1 - p0 : p0;
    for (int i = t; i < cnt; i += kTileThreads)
      cp_async_elem(row + slot(i), reverse ? src - i : src + i);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int mine = max(0, min(SUB, cnt - t * SUB));
  const auto col = [&](int jj) { return st + jj * kTileThreads + t; };

  // The fold, the in-tile scan and the look-back: the state at the tile's
  // start, then at the thread's first element.
  V acc = V::identity();
  for (int jj = 0; jj < mine; ++jj) Op::fold(acc, op.template elem<LD>(col(jj)));
  const V pre = tile_scan<V>(acc, scan_sm, agg);
  if (warp == 0)
    group_lookback<V, SZ, true>(b, lay.nt, lay.slots(work, grp, V::S), agg, win, start,
                                [](const Acc* map, Acc* s) { Op::apply(map, s); });
  __syncthreads();
  Acc s[SZ];
#pragma unroll
  for (int c = 0; c < SZ; ++c) s[c] = start[c];
  Op::apply(pre.v, s);

  // The walk: each element's state over its staged inputs, then out.
  for (int jj = 0; jj < mine; ++jj) {
    S* o = col(jj);
    const auto x = op.template elem<LD>(o);
    if (!inclusive)
#pragma unroll
      for (int c = 0; c < SZ; ++c) o[c * LD] = S(s[c]);
    Op::step(x, s);
    if (inclusive)
#pragma unroll
      for (int c = 0; c < SZ; ++c) o[c * LD] = S(s[c]);
  }
  __syncthreads();
  for (int c = 0; c < SZ; ++c) {
    S* dst = op.dst(c, grp, n);
    if (!dst) continue;
    dst += reverse ? n - 1 - p0 : p0;
    for (int i = t; i < cnt; i += kTileThreads)
      (reverse ? dst[-i] : dst[i]) = st[c * LD + slot(i)];
  }
}

// ------------------------------------------------------------------- host side

// The schedule of a scan: a tile's elements and a thread's, the affine
// columns a block takes and the column groups (1 for the other monoids).
struct Schedule {
  int tile, sub, cols, groups;
};

// Components staged an element, of the map and of the state.
inline int staged_components(int kind, int m, int cols) {
  switch (kind) {
    case kAff: return m * m + m * cols;
    case kCong: return 2 * m * m;
    case kRic: return 1 + 2 * m + m * m;
    case kCpl: return 3 * m * m;
    default: return -1;
  }
}

inline int map_size(int kind, int m, int cols) {
  return kind == kRic || kind == kCpl ? 3 * m * m : kind == kCong ? 2 * m * m : m * m + m * cols;
}

inline int state_size(int kind, int m, int cols) { return kind == kAff ? m * cols : m * m; }

// -1 for an unsupported kind, m or r.
inline int plan(int kind, int m, long long n, int r, int bytes, Schedule& p) {
  if (kind < kAff || kind > kCpl || m < 1 || m > 4 || n < 1 || r < 1 || r > 65535 ||
      (kind != kAff && r != 1) || (bytes != 4 && bytes != 8))
    return -1;
  p.cols = kind == kAff && r > 1 ? kAffCols : 1;
  p.groups = (r + p.cols - 1) / p.cols;
  p.sub = b3_sub(staged_components(kind, m, p.cols) * bytes);
  p.tile = kTileThreads * p.sub;
  return 0;
}

inline ChainLayout layout(int kind, int m, long long n, const Schedule& p) {
  return ChainLayout((n + p.tile - 1) / p.tile, p.groups, map_size(kind, m, p.cols),
                     state_size(kind, m, p.cols));
}

// Workspace, in Acc: the larger of the two storage types' layouts (their
// tiles differ).
long long workspace_elems(int kind, int m, long long n, int r) {
  long long most = -1;
  for (int bytes : {4, 8}) {
    Schedule p;
    if (plan(kind, m, n, r, bytes, p) < 0) return -1;
    const long long total = layout(kind, m, n, p).total;
    if (total > most) most = total;
  }
  return most;
}

// One memset (the ticket and the flags) and one launch, on stream s.
template <class Op>
cudaError_t run(const Op& op, long long n, int reverse, int inclusive, const Schedule& p,
                const ChainLayout& lay, Acc* work, cudaStream_t s) {
  constexpr long long smem = b3_smem<Op>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        b3_tile_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaMemsetAsync(work + lay.flags, 0, lay.flag_words * sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  b3_tile_kernel<Op><<<(unsigned)(lay.nt * p.groups), kTileThreads, smem, s>>>(
      op, n, reverse, inclusive, p.groups, work, lay);
  return cudaGetLastError();
}

template <typename S, int M>
cudaError_t dispatch(int kind, long long n, int r, int reverse, int inclusive, const Schedule& p,
                     const ChainLayout& lay, const S* x0, const S* x1, const S* x2, const S* x3,
                     S* out, Acc* work, cudaStream_t s) {
  switch (kind) {
    case kAff:
      if (p.cols == 1)
        return run(AffOp<S, M, 1>{x0, x1, out, r}, n, reverse, inclusive, p, lay, work, s);
      return run(AffOp<S, M, kAffCols>{x0, x1, out, r}, n, reverse, inclusive, p, lay, work, s);
    case kCong:
      return run(CongOp<S, M>{x0, x1, out}, n, reverse, inclusive, p, lay, work, s);
    case kRic:
      return run(RicOp<S, M>{x0, x1, x2, x3, out}, n, reverse, inclusive, p, lay, work, s);
    default:
      return run(CplOp<S, M>{x0, x1, x2, out}, n, reverse, inclusive, p, lay, work, s);
  }
}

template <typename S>
int scan(int kind, int m, long long n, int r, int reverse, int inclusive,
         const S* x0, const S* x1, const S* x2, const S* x3, S* out, Acc* work,
         long long work_elems, void* stream) {
  Schedule p;
  if (plan(kind, m, n, r, (int)sizeof(S), p) < 0) return (int)cudaErrorInvalidValue;
  const ChainLayout lay = layout(kind, m, n, p);
  if (work_elems < lay.total || lay.nt * p.groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)dispatch<S, 1>(kind, n, r, reverse, inclusive, p, lay, x0, x1, x2, x3, out, work, s);
    case 2: return (int)dispatch<S, 2>(kind, n, r, reverse, inclusive, p, lay, x0, x1, x2, x3, out, work, s);
    case 3: return (int)dispatch<S, 3>(kind, n, r, reverse, inclusive, p, lay, x0, x1, x2, x3, out, work, s);
    default: return (int)dispatch<S, 4>(kind, n, r, reverse, inclusive, p, lay, x0, x1, x2, x3, out, work, s);
  }
}

}  // namespace

extern "C" {

// Workspace a scan needs, in float64 elements; -1 for an unsupported kind,
// m or r. kind: 0 affine, 1 congruence, 2 Riccati, 3 coupling (m1 = m2 = m).
long long qss_workspace_elems(int kind, int m, long long n, int r) {
  return workspace_elems(kind, m, n, r);
}

// The launch's association for operands of `bytes` bytes: elements per
// tile and per thread into tile[0], sub[0], and the affine columns a block
// takes into cols[0]; returns 0, or -1 for what the kernel does not take.
int qss_schedule(int kind, int m, int r, int bytes, int* tile, int* sub, int* cols) {
  Schedule p;
  if (plan(kind, m, 1, r, bytes, p) < 0) return -1;
  *tile = p.tile;
  *sub = p.sub;
  *cols = p.cols;
  return 0;
}

// One scan into out. Operands by kind: affine (A, B), congruence (A, B),
// Riccati (d, ps, qs, as), coupling (A, B, C); unused pointers are null.
// r is the affine scan's number of columns (1 for the other kinds).
// Returns a cudaError_t code: nonzero if an argument is refused or a
// launch failed.
int qss_scan_f32(int kind, int m, long long n, int r, int reverse, int inclusive,
                 const float* x0, const float* x1, const float* x2,
                 const float* x3, float* out, double* work, long long work_elems,
                 void* stream) {
  return scan<float>(kind, m, n, r, reverse, inclusive, x0, x1, x2, x3, out,
                     work, work_elems, stream);
}

int qss_scan_f64(int kind, int m, long long n, int r, int reverse, int inclusive,
                 const double* x0, const double* x1, const double* x2,
                 const double* x3, double* out, double* work,
                 long long work_elems, void* stream) {
  return scan<double>(kind, m, n, r, reverse, inclusive, x0, x1, x2, x3, out,
                      work, work_elems, stream);
}

const char* qss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
