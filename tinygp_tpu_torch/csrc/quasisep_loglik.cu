// Quasiseparable GP log-likelihood terms on Hopper (sm_90a): kernels B1 and
// B1r at m = 1..4.
//
// Replaces the TPU kernel tinygp_tpu/solvers/quasisep/pallas_loglik.py:
// _loglik_kernel (line 86), launched by _call_kernel (line 275): with
// residuals=False as B1 (entries qsl_loglik_*), with residuals=True (from
// _fused_fwd, line 409) as B1r (entries qsl_loglik_res_*). For
// K = diag(d) + tril(p, q, a) + tril(p, q, a)^T with an m x m state it
// returns (quad, logdet) = (sum alpha^2, sum log c):
// the Riccati covariance flow F, the Cholesky emissions
// c = sqrt(d - p^T F p) and w = (q - a F p) / c, the whitening affine scan
// e with A = a - (w / c) p^T and B = (w / c) y, and alpha = (y - p^T e) / c.
// B1r also writes, for each element k, the residuals that the backward
// kernel (quasisep_loglik_bwd.cu) reads: the exclusive Riccati state F_k
// (m*m, n), the exclusive whitening state e_k (m, n) and 1/c_k (n), in the
// operands' type.
//
// Operands are stacked as in the JAX package: d, y of length n; ps, qs of
// shape (m, n); as of shape (m*m, n), row i*m+j holding a[i, j]; all
// row-major and contiguous, in float32 or float64.
//
// Precision. Whatever the operands' type, every scan runs in float64
// (`Acc`), and so does the workspace. Composing the Riccati Moebius maps of
// long spans in float32 loses the state: on the Matern-3/2 benchmark at
// n = 1e6 (sorted uniform points on [0, 10], diag 0.1), a float32 build of
// this kernel started its chunks from an F far from the float64 flow and
// returned NaN.
//
// What bounds it: bytes. The function must read (m*m + 2m + 2) values per
// element once and writes two scalars: 40 MB at n = 1e6, m = 2 in float32,
// 11.9 us at 3.35 TB/s. B1r writes (m*m + m + 1) values per element more:
// 68 MB and 20.3 us. The sequential algorithm's arithmetic, about 100
// flops per element for m = 2, would take 1.4 us at the float32 peak.
//
// Design: one launch (and one memset of its flags), the GPU form of the
// TPU kernel's carried grid, as B2's (quasisep_loglik_bwd.cu) run forwards.
// Each block takes a tile of kTileThreads * sub consecutive elements by a
// ticket (quasisep_common.cuh: the one-launch look-back); thread t owns the
// sub elements t * sub .. t * sub + sub - 1 of it.
//
//   staging: every operand's run for the tile is contiguous, so the block
//            copies each component once, coalesced, with cp.async into
//            shared memory (thread t's element jj at slot jj * kTileThreads
//            + t, so that the phases' reads are conflict-free); nothing is
//            read from device memory again.
//   phase A: each thread folds its elements' Riccati maps into one Moebius
//            triple (A, F, G) with the rank-one step (no inverse:
//            A' = a A - u w^T / c, F' = a F a^T + u u^T / c,
//            G' = G - w w^T / c, with f = F p, c = d - p^T f, u = q - a f
//            and w = A^T p; quasisep_generic.cuh derives it); a
//            warp-shuffle scan gives each thread its exclusive prefix and
//            the tile its aggregate; the tile publishes it, and the
//            look-back gives F at the tile's start (the flow starts at
//            F = 0).
//   phase B: each thread walks its elements with the sequential recurrence
//            F' = a F a^T + u u^T / c2 from its prefix's state, forms the
//            whitening elements (a - wd p^T, wd y), wd = u / c2, and folds
//            them; the same scan, publication and look-back give e at the
//            tile's start (from e = 0).
//   phase C: each thread walks its elements once more for alpha and log c
//            (B1r: and puts each element's F, e and 1/c over its staged
//            inputs; the block writes them out coalesced). The threads'
//            partial sums are reduced over the tile in a fixed order; the
//            last tile to finish, counted on a second ticket, sums the
//            tiles' partials in tile order. So the result is deterministic,
//            with no float atomics.
//
// The look-back folds the earlier tiles' aggregates of the tile's group in
// order and applies the earlier groups' aggregates to a published group
// state one group at a time, so its result is one fixed association
// whichever tiles it found published, and two launches on the same inputs
// agree bit for bit. cuda_loglik.plain_loglik_terms_res_tiled is this
// association in plain PyTorch. Since the walks run the sequential
// recurrence while the scans compose Moebius maps, agreement with the plain
// sequential version checks the algorithm and not only the code. The
// ragged last tile is masked; nothing is padded. The cost against the
// bound: float64 arithmetic, and the latency of a tile's staging, three
// walks, two in-tile scans and two look-backs (the Riccati one composing
// full Moebius maps, with an m x m inverse each).
//
// A chain axis (qsl_loglik_chains_*): many problems of one order and
// length in one launch, for the samplers, which evaluate every chain's log
// density at once (the TPU kernel has none: under vmap the JAX package
// leaves the likelihood to XLA). The ticket runs over (chain, tile),
// chain-major, so a tile still waits only on earlier tiles of its own
// chain; each chain has its own workspace (look-back, partials, finish
// ticket), zeroed by one 2-D memset; each operand has a chain stride, 0 for
// one that every chain shares (the data y), so nothing is copied. A chain's
// arithmetic is the unbatched launch's, bit for bit.

#include "quasisep_common.cuh"

namespace {

// Elements per thread: tiles of 512 elements at m <= 2, 256 at m = 3, 4.
// cuda_loglik._B1_SCHEDULE repeats it.
__host__ __device__ constexpr int b1_sub(int m) { return m <= 2 ? 8 : 4; }

// The staged components of an element, in shared memory: [d | y | p (m) |
// q (m) | a (m x m)], component c of slot s at [c * ld + s]. B1r's phase C
// puts the outputs [F (m x m) | e (m) | 1/c] over the first of them.
template <int M>
struct B1Layout {
  static constexpr int MM = M * M, D = 0, Y = 1, P = 2, Q = 2 + M, A = 2 + 2 * M,
                       IN = 2 + 2 * M + MM, OUT = MM + M + 1;
};

// One element's operands, read from its staged column into Acc: the
// Riccati element and y.
template <int M>
struct Elem : RicElem<M> {
  static constexpr int MM = M * M;
  Acc y;

  template <int LD, typename S>
  __device__ __forceinline__ static Elem at(const S* col) {
    using L = B1Layout<M>;
    Elem el;
    el.d = Acc(col[L::D * LD]);
    el.y = Acc(col[L::Y * LD]);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      el.p[i] = Acc(col[(L::P + i) * LD]);
      el.q[i] = Acc(col[(L::Q + i) * LD]);
    }
#pragma unroll
    for (int c = 0; c < MM; ++c) el.a[c] = Acc(col[(L::A + c) * LD]);
    return el;
  }

  // The whitening element (a - wd p^T, wd y), wd = u / c2, folded after
  // the running map x: A' = A_el A, B' = A_el B + B_el.
  __device__ __forceinline__ void fold_affine(Aff<Acc, M>& x, const Acc* u, Acc c2) const {
    const Acc inv_c2 = Acc(1) / c2;
    Acc step[MM], wd[M], nA[MM], nB[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      wd[i] = u[i] * inv_c2;
#pragma unroll
      for (int j = 0; j < M; ++j) step[i * M + j] = this->a[i * M + j] - wd[i] * this->p[j];
    }
    mm<Acc, M>(step, x.v, nA);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = wd[i] * y;
#pragma unroll
      for (int j = 0; j < M; ++j) acc += step[i * M + j] * x.v[MM + j];
      nB[i] = acc;
    }
#pragma unroll
    for (int c = 0; c < MM; ++c) x.v[c] = nA[c];
#pragma unroll
    for (int i = 0; i < M; ++i) x.v[MM + i] = nB[i];
  }
};

template <typename S>
struct FwdArgs {
  const S *d, *ps, *qs, *as, *y;
  S *out, *Fs, *es, *ics;  // Fs, es, ics: B1r's residuals, null for B1
  // The chain strides of d, ps, qs, as and y, in elements: 0 for an
  // operand that every chain shares. The outputs are contiguous by chain.
  long long cs[5];

  // The operands and outputs of chain c.
  __device__ __forceinline__ void shift(long long c, long long n, int m) {
    d += c * cs[0];
    ps += c * cs[1];
    qs += c * cs[2];
    as += c * cs[3];
    y += c * cs[4];
    out += 2 * c;
    if (Fs) {
      Fs += c * m * m * n;
      es += c * m * n;
      ics += c * n;
    }
  }
};

// B1's workspace at order m: the look-back's (the Riccati scan, maps of
// 3 m^2 and states of m^2; the whitening scan, m^2 + m and m), one more
// 32-bit word after its flags (the finish ticket, zeroed with them), and
// each tile's two partial sums.
struct B1Work {
  LookLayout look;
  long long partials, total;
  __host__ __device__ B1Work(long long nt, int m)
      : look(nt, 3 * m * m, m * m, m * m + m, m) {
    partials = look.flags + (look.flag_words + 2) / 2;
    total = partials + 2 * nt;
  }
  __device__ unsigned* finished(Acc* work) const { return look.ticket(work) + look.flag_words; }
};

template <int M>
B1Work b1_work(long long n) {
  const long long tile = kTileThreads * b1_sub(M);
  return B1Work((n + tile - 1) / tile, M);
}

// Shared memory of a block, in bytes: the look-back window (also the final
// reduction's scratch), the scan's warp total, the tile's aggregate and
// the state at the tile's start (all Acc), then the staged tile.
template <int M>
__host__ __device__ constexpr int b1_window() {
  return kLookWindow * 3 * M * M > 2 * kTileThreads ? kLookWindow * 3 * M * M
                                                     : 2 * kTileThreads;
}

template <typename S, int M>
constexpr long long b1_smem() {
  constexpr int MM = M * M, T = kTileThreads * b1_sub(M);
  return (long long)(b1_window<M>() + 7 * MM) * sizeof(Acc) +
         (long long)B1Layout<M>::IN * (T + 1) * sizeof(S);
}

// The two sums of the tile's threads into red[0], red[kTileThreads], in a
// fixed order (red: 2 kTileThreads values of shared memory).
__device__ __forceinline__ void tile_sum2(Acc* red, Acc x0, Acc x1) {
  const int t = threadIdx.x;
  red[t] = x0;
  red[kTileThreads + t] = x1;
  __syncthreads();
  for (int s = kTileThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[t] += red[t + s];
      red[kTileThreads + t] += red[kTileThreads + t + s];
    }
    __syncthreads();
  }
}

template <typename S, int M, bool kRes>
__global__ void __launch_bounds__(kTileThreads)
b1_tile_kernel(long long n, FwdArgs<S> x, Acc* work, B1Work lay) {
  using L = B1Layout<M>;
  using R = Ric<Acc, M>;
  using A = Aff<Acc, M>;
  constexpr int MM = M * M, SUB = b1_sub(M), T = kTileThreads * SUB, LD = T + 1;
  using E = Elem<M>;
  __shared__ long long tile_of_block;
  __shared__ bool last_tile;
  const long long nt = lay.look.nt;
  Acc* win = reinterpret_cast<Acc*>(qsl_smem);
  Acc* scan_sm = win + b1_window<M>();
  Acc* agg = scan_sm + R::S;
  Acc* start = agg + R::S;
  S* st = reinterpret_cast<S*>(start + MM);
  const int t = threadIdx.x, warp = t >> 5;

  // The ticket runs over (chain, tile), chain-major, so a tile waits only
  // on earlier tiles of its own chain, which earlier tickets took. Each
  // chain has its own workspace (look-back, partials, finish ticket); the
  // first chain's holds the ticket.
  if (t == 0) tile_of_block = atomicAdd(lay.look.ticket(work), 1u);
  __syncthreads();
  const long long chain = tile_of_block / nt, b = tile_of_block - chain * nt, k0 = b * T;
  const int cnt = (int)(n - k0 < T ? n - k0 : T);
  work += chain * lay.total;
  x.shift(chain, n, M);
  const LookSlots ric_sl = lay.look.slots(work, 0), aff_sl = lay.look.slots(work, 1);

  // Stage the tile: element k0 + i of component c at slot
  // (i % SUB) * kTileThreads + i / SUB.
  for (int c = 0; c < L::IN; ++c) {
    const S* src = c == L::D   ? x.d
                   : c == L::Y ? x.y
                   : c < L::Q  ? x.ps + (long long)(c - L::P) * n
                   : c < L::A  ? x.qs + (long long)(c - L::Q) * n
                               : x.as + (long long)(c - L::A) * n;
    src += k0;
    for (int i = t; i < cnt; i += kTileThreads)
      cp_async_elem(st + c * LD + (i % SUB) * kTileThreads + i / SUB, src + i);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int mine = max(0, min(SUB, cnt - t * SUB));
  const auto col = [&](int jj) { return st + jj * kTileThreads + t; };

  // Phase A: the Riccati flow. The tile's aggregate, then F at its start
  // from the look-back.
  R racc = R::identity();
  for (int jj = 0; jj < mine; ++jj) E::template at<LD>(col(jj)).fold(racc);
  const R rpre = tile_scan<R>(racc, scan_sm, agg);
  if (warp == 0)
    group_lookback<R, MM, true>(b, nt, ric_sl, agg, win, start,
                          [](const Acc* map, Acc* s) { ric_apply<M>(map, s); });
  __syncthreads();
  // F at the thread's first element: its prefix applied to the tile's start.
  Acc F0[MM];
#pragma unroll
  for (int c = 0; c < MM; ++c) F0[c] = start[c];
  ric_apply<M>(rpre.v, F0);

  // Phase B: the whitening elements from the sequential flow.
  A aacc = A::identity();
  {
    Acc F[MM];
#pragma unroll
    for (int c = 0; c < MM; ++c) F[c] = F0[c];
    for (int jj = 0; jj < mine; ++jj) {
      const E el = E::template at<LD>(col(jj));
      Acc u[M];
      const Acc c2 = el.emit(F, u);
      el.fold_affine(aacc, u, c2);
      el.advance(F, u, c2);
    }
  }
  const A apre = tile_scan<A>(aacc, scan_sm, agg);
  if (warp == 0)
    group_lookback<A, M, true>(b, nt, aff_sl, agg, win, start,
                         [](const Acc* map, Acc* s) { aff_apply<M>(map, s); });
  __syncthreads();
  Acc e[M];
#pragma unroll
  for (int i = 0; i < M; ++i) e[i] = start[i];
  aff_apply<M>(apre.v, e);

  // Phase C: alpha and log c from both recurrences (B1r: the residuals of
  // each element over its staged inputs).
  Acc quad = Acc(0), logdet = Acc(0);
  for (int jj = 0; jj < mine; ++jj) {
    const E el = E::template at<LD>(col(jj));
    Acc u[M];
    const Acc c2 = el.emit(F0, u);
    const Acc c = sqrt(c2), ic = Acc(1) / c;
    Acc pe = Acc(0);
#pragma unroll
    for (int i = 0; i < M; ++i) pe += el.p[i] * e[i];
    const Acc r = el.y - pe, alpha = r * ic;
    quad += alpha * alpha;
    logdet += log(c);
    if constexpr (kRes) {
      S* o = col(jj);
#pragma unroll
      for (int k = 0; k < MM; ++k) o[k * LD] = S(F0[k]);
#pragma unroll
      for (int i = 0; i < M; ++i) o[(MM + i) * LD] = S(e[i]);
      o[(MM + M) * LD] = S(ic);
    }
    // e <- (a - wd p^T) e + wd y = a e + wd (y - p.e), wd = u / c2.
    const Acc rc = r / c2;
    Acc ne[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Acc acc = u[i] * rc;
#pragma unroll
      for (int j = 0; j < M; ++j) acc += el.a[i * M + j] * e[j];
      ne[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) e[i] = ne[i];
    el.advance(F0, u, c2);
  }
  if constexpr (kRes) {
    __syncthreads();
    for (int c = 0; c < L::OUT; ++c) {
      S* dst = c < MM       ? x.Fs + (long long)c * n
               : c < MM + M ? x.es + (long long)(c - MM) * n
                            : x.ics;
      dst += k0;
      for (int i = t; i < cnt; i += kTileThreads)
        dst[i] = st[c * LD + (i % SUB) * kTileThreads + i / SUB];
    }
  }

  // The tile's partial sums, then the last tile to finish sums them all in
  // tile order.
  tile_sum2(win, quad, logdet);
  Acc* partials = work + lay.partials;
  if (t == 0) {
    partials[2 * b] = win[0];
    partials[2 * b + 1] = win[kTileThreads];
    __threadfence();
    last_tile = atomicAdd(lay.finished(work), 1u) == (unsigned)(nt - 1);
  }
  __syncthreads();
  if (!last_tile) return;
  __threadfence();
  quad = logdet = Acc(0);
  for (long long i = t; i < nt; i += kTileThreads) {
    quad += __ldcg(partials + 2 * i);
    logdet += __ldcg(partials + 2 * i + 1);
  }
  tile_sum2(win, quad, logdet);
  if (t == 0) {
    x.out[0] = S(win[0]);
    x.out[1] = S(win[kTileThreads]);
  }
}

// ------------------------------------------------------------------- host side

long long workspace_elems(int m, long long n) {
  switch (m) {
    case 1: return b1_work<1>(n).total;
    case 2: return b1_work<2>(n).total;
    case 3: return b1_work<3>(n).total;
    case 4: return b1_work<4>(n).total;
    default: return -1;
  }
}

// One memset (each chain's flags and finish ticket, the first chain's
// ticket with them) and one launch of chains x tiles blocks, on stream s.
template <typename S, int M, bool kRes>
cudaError_t launch(long long n, long long chains, const FwdArgs<S>& x, Acc* work,
                   cudaStream_t s) {
  const B1Work W = b1_work<M>(n);
  if (chains * W.look.nt >= (1ll << 31)) return cudaErrorInvalidValue;  // the grid, the ticket
  constexpr long long smem = b1_smem<S, M>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        b1_tile_kernel<S, M, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaMemset2DAsync(work + W.look.flags, W.total * sizeof(Acc), 0,
                                    (W.look.flag_words + 1) * sizeof(unsigned), chains, s);
  if (e != cudaSuccess) return e;
  b1_tile_kernel<S, M, kRes>
      <<<(unsigned)(chains * W.look.nt), kTileThreads, smem, s>>>(n, x, work, W);
  return cudaGetLastError();
}

template <typename S, int M>
cudaError_t run(long long n, long long chains, const FwdArgs<S>& x, Acc* work, cudaStream_t s) {
  return x.Fs ? launch<S, M, true>(n, chains, x, work, s)
              : launch<S, M, false>(n, chains, x, work, s);
}

template <typename S>
int loglik(int m, long long n, long long chains, const FwdArgs<S>& x, Acc* work,
           long long work_elems, void* stream) {
  if (n < 1 || chains < 1 || workspace_elems(m, n) < 0 ||
      work_elems < chains * workspace_elems(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)run<S, 1>(n, chains, x, work, s);
    case 2: return (int)run<S, 2>(n, chains, x, work, s);
    case 3: return (int)run<S, 3>(n, chains, x, work, s);
    default: return (int)run<S, 4>(n, chains, x, work, s);
  }
}

// The C entries' operands: the chain strides of d, ps, qs, as and y, or
// all 0 for one unbatched problem.
template <typename S>
FwdArgs<S> fwd_args(const S* d, const S* ps, const S* qs, const S* as, const S* y, S* out,
                    S* Fs, S* es, S* ics, const long long* strides) {
  FwdArgs<S> x{d, ps, qs, as, y, out, Fs, es, ics, {0, 0, 0, 0, 0}};
  if (strides)
    for (int k = 0; k < 5; ++k) x.cs[k] = strides[k];
  return x;
}

}  // namespace

extern "C" {

// Workspace the launch needs, in float64 elements, per chain; -1 for an
// unsupported m.
long long qsl_workspace_elems(int m, int n) { return workspace_elems(m, n); }

// The launch's association for operands of `bytes` bytes: elements per
// tile and per team (one thread) into tile[0], sub[0]; returns 0, or -1
// for an unsupported m.
int qsl_fwd_schedule(int m, int bytes, int* tile, int* sub) {
  if (m < 1 || m > 4 || (bytes != 4 && bytes != 8)) return -1;
  *sub = b1_sub(m);
  *tile = kTileThreads * b1_sub(m);
  return 0;
}

// (quad, logdet) into out[0], out[1]. Returns a cudaError_t code: nonzero
// if an argument is refused or a launch failed.
int qsl_loglik_f32(int m, int n, const float* d, const float* ps,
                   const float* qs, const float* as, const float* y,
                   float* out, double* work, long long work_elems,
                   void* stream) {
  const FwdArgs<float> x = fwd_args<float>(d, ps, qs, as, y, out, nullptr, nullptr, nullptr,
                                           nullptr);
  return loglik<float>(m, n, 1, x, work, work_elems, stream);
}

int qsl_loglik_f64(int m, int n, const double* d, const double* ps,
                   const double* qs, const double* as, const double* y,
                   double* out, double* work, long long work_elems,
                   void* stream) {
  const FwdArgs<double> x = fwd_args<double>(d, ps, qs, as, y, out, nullptr, nullptr, nullptr,
                                             nullptr);
  return loglik<double>(m, n, 1, x, work, work_elems, stream);
}

// B1r: (quad, logdet) as above, and the residuals F (m*m, n), e (m, n) and
// 1/c (n), in the operands' type. The same workspace as B1.
int qsl_loglik_res_f32(int m, int n, const float* d, const float* ps,
                       const float* qs, const float* as, const float* y,
                       float* out, float* Fs, float* es, float* ics,
                       double* work, long long work_elems, void* stream) {
  const FwdArgs<float> x = fwd_args<float>(d, ps, qs, as, y, out, Fs, es, ics, nullptr);
  return loglik<float>(m, n, 1, x, work, work_elems, stream);
}

int qsl_loglik_res_f64(int m, int n, const double* d, const double* ps,
                       const double* qs, const double* as, const double* y,
                       double* out, double* Fs, double* es, double* ics,
                       double* work, long long work_elems, void* stream) {
  const FwdArgs<double> x = fwd_args<double>(d, ps, qs, as, y, out, Fs, es, ics, nullptr);
  return loglik<double>(m, n, 1, x, work, work_elems, stream);
}

// B1 and B1r with a leading chain axis: `chains` problems of one order and
// length in one launch, chain c's operand at its pointer plus c times its
// stride (strides: d, ps, qs, as, y, in elements; 0 for an operand that
// every chain shares), its outputs at out + 2 c, Fs + c m^2 n, es + c m n,
// ics + c n. Each chain's result is bit for bit that of the unbatched
// launch on its operands. Fs, es and ics null: B1. The workspace is
// `chains` times qsl_workspace_elems.
int qsl_loglik_chains_f32(int m, int n, int chains, const long long* strides, const float* d,
                          const float* ps, const float* qs, const float* as, const float* y,
                          float* out, float* Fs, float* es, float* ics, double* work,
                          long long work_elems, void* stream) {
  const FwdArgs<float> x = fwd_args<float>(d, ps, qs, as, y, out, Fs, es, ics, strides);
  return loglik<float>(m, n, chains, x, work, work_elems, stream);
}

int qsl_loglik_chains_f64(int m, int n, int chains, const long long* strides, const double* d,
                          const double* ps, const double* qs, const double* as, const double* y,
                          double* out, double* Fs, double* es, double* ics, double* work,
                          long long work_elems, void* stream) {
  const FwdArgs<double> x = fwd_args<double>(d, ps, qs, as, y, out, Fs, es, ics, strides);
  return loglik<double>(m, n, chains, x, work, work_elems, stream);
}

const char* qsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
