// K3, K4, K5: the Pippenger multi-scalar multiplication of the verify and
// prove paths, G1 (Fq) and G2 (Fq2), one C entry point per kernel and group.
//
// Replaces the TPU kernels of phase2_bn254_tpu/ops/pallas_msm.py:
//   K3 bucket_accumulate  <- _wave_accumulate (_wave_kernel)
//   K4 bucket_reduce      <- _suffix_reduce (_suffix_kernel)
//   K5 combine_windows    <- _combine_windows (_combine_kernel, with its
//                            hot-bucket fold, the exclude mode)
// and their signed-digit mode (PHASE2_TPU_MSM_SIGNED: _wave_kernel's
// tri-state validity, _suffix_reduce's all-lane weight mask).
// What the three compute is that of the TPU kernels; the TPU's dense wave
// grid (packed rows, the kernel-transpose mode, the wave cap and its host
// sync, the hot-bucket dense pass) is not carried over. ops/msm.py prepares
// the inputs on the device: for each c-bit window w (least significant
// first) the point indices sorted by bucket (`orders`, (nwin, N)); each
// bucket's start and count in that order and the index of its first
// sub-run ((nwin, B), B = 2^c; digit 0 has count 0); and the bucket of each
// sub-run (`runs`, (nwin, M), B past the last). A sub-run is at most L
// consecutive points of one bucket's run (L = msm.SUBRUN): bucket d's i-th
// sub-run holds its points i L .. min((i + 1) L, count) - 1. M = ceil(N / L)
// + B bounds the sub-runs of a window whatever the digits, so no shape
// depends on the data. In the signed mode a digit e in [-2^(c-1), 2^(c-1))
// goes to bucket |e| - 1 of B = 2^(c-1), each bucket's run holds its
// negative digits first, and `splits` ((nwin, B)) says where its positive
// ones begin: K3 negates the y of a point sorted below its bucket's split,
// and K4 weights bucket l by l + 1. The sign rides on `splits`, not on
// `orders`, so `orders` stays the sort's permutation, which the unsigned
// mode and the plain version share, and no pass over it marks the signs; a
// thread reads its bucket's split once.
//
// Every kernel computes S MSMs at once that share the scalars: set s takes
// the points shifts[s] .. shifts[s] + N - 1 of one array (power_pairs' v[:-1]
// and v[1:], S = 2).
// K3 (2 + levels launches): pass A, one thread per (set, window, sub-run),
//   mixed-adds its <= L affine points (skipping points at infinity) into a
//   Jacobian partial that starts at infinity; then `levels` = ceil(log2(
//   ceil(N / L))) tree launches, in level k the partial of local index i
//   (i % 2^(k+1) == 0) of each digit adds the one of index i + 2^k, if the
//   digit has it; then one thread per (set, window, digit) collects the
//   digit's first partial (infinity if it has none). Out: (S, nwin, B)
//   Jacobian bucket sums indexed by digit (the top window's digits have
//   fewer than c bits; its upper buckets stay at infinity).
// K4: one block of T threads per (set, window) (T a power of two dividing
//   B, at most kReduceThreads): sum_l l S_l. Thread j sums its own range of
//   m = B / T buckets by the running-sum trick (R_j, and W_j = sum (l - j m)
//   S_l over its range); a suffix scan over the block gives Suf_j = sum_{j'
//   >= j} R_j', so that sum_l l S_l = sum_j (W_j + m Suf_j [j > 0]); each
//   thread multiplies its Suf_j by m with log2 m doublings, adds W_j, and a
//   tree over the block sums the T points. Signed, sum_l (l + 1) S_l adds
//   the total Suf_0 once: thread 0's term is W_0 + Suf_0. A lane to exclude
//   per (set, window) (-1: none; the hot-bucket fold's d*) counts as
//   infinity. Out: (S, nwin) window sums.
// K5: one warp per set: sum_w 2^(c w) (T_w + e_w H_w), e_w H_w the fold
//   (H_w = S[w, d*_w], K3's sum of the bucket K4 left out, e_w its weight,
//   0 for none), as one chain from the most significant window: at each of
//   the c w + i below a window's top a doubling (none while the point is at
//   infinity), an add of H_w where bit i of e_w is set, and at i = 0 the add
//   of T_w. The fold thus costs its adds and no doubling of its own; a
//   window of weight 0 skips it on a branch the warp takes as one. The
//   chain is
//   latency-bound (2 sets on 2 SMs at the verify chunk, c (nwin - 1)
//   dependent doublings whatever the grouping of the windows), so the
//   design shortens it: each level of independent products of a doubling
//   (3 levels of 7 products) or an add (5 of 16) runs one product a lane
//   (Fq2: one Karatsuba term a lane) and the lanes share the results by
//   __shfl_sync. A doubling costs 3 product latencies, where one thread
//   pays 7. Out: (S) Jacobian points.
// All values Montgomery, fully reduced; int64 16-bit digits as the tensors.
//
// What bounds them on this card: 32-bit integer multiply throughput inside
// per-thread chains of group operations (11 Montgomery products per mixed
// add, 16 per add, 7 per doubling), and the latency of those chains where
// too few threads run. The design bounds every chain whatever the digit
// distribution: a K3 thread does at most L mixed adds and then at most
// ceil(log2(N / L)) adds (an all-equal chunk or a witness' ones spread over
// N / L threads and a tree instead of one thread's run), which gives K3 4x
// the threads of one thread per bucket on uniform scalars, so the
// multiplier rate of its field code, not a chain, sets its time (PERF.md).
// A K4 thread does 2 m - 1 adds, 2 log2 T adds and log2 m doublings (21
// group operations at c = 9, 52 at c = 12, where one thread per window
// would do 2 (B - 1)); with a block per window on 132 SMs K4's time is
// still that chain's latency. K4 keeps one Jacobian point a thread in
// shared memory (T x 192 bytes for G2, 48 KB at T = 256). The point gathers
// of K3 (256 or 512 bytes of int64 digits per affine point through
// `orders`) hit the L2 cache: a verify chunk's points are 16 or 32 MB.
//
// Outside nvcc (no __CUDACC__) only the per-thread functions are compiled,
// so a host C++ compiler can run the arithmetic on the CPU, thread by thread
// in the kernels' order.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// K3 pass A, thread t = (s * nwin + w) * m + j: sub-run j of window w;
// with splits (the signed mode), a point sorted below its bucket's split
// adds as (x, p - y)
template <class F>
__device__ void accumulate_subrun(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts,
                                  const int64_t* orders, const int64_t* starts, const int64_t* counts,
                                  const int64_t* first, const int64_t* runs, int64_t* px, int64_t* py, int64_t* pz,
                                  int64_t t, int n, int nwin, int m, int b, int sub,
                                  const int64_t* splits = nullptr) {
  int64_t j = t % m, w = t / m % nwin, shift = shifts[t / m / nwin];
  int64_t d = runs[w * m + j];
  Jac<F> acc = jac_infinity<F>();
  if (d < b) {
    int64_t k = w * b + d, i = j - first[k];
    int64_t lo = starts[k] + i * sub, end = starts[k] + counts[k];
    int64_t hi = lo + sub < end ? lo + sub : end;
    int64_t split = splits ? splits[k] : 0;
    const int64_t* order = orders + w * n;
    for (int64_t pos = lo; pos < hi; ++pos) {
      int64_t p = order[pos] + shift;
      if (inf[p]) continue;
      F qx, qy;
      load_el(x + kDigits<F> * p, qx);
      load_el(y + kDigits<F> * p, qy);
      if (splits && pos < split) qy = neg(qy);
      acc = jac_madd(acc, qx, qy);
    }
  }
  store_jac(px, py, pz, t, acc);
}

// K3 tree level `level`, thread t as in pass A: the partial of local index
// i adds the one of index i + 2^level (the same digit's) where i is a
// multiple of 2^(level + 1); no other thread of the level reads or writes
// either
template <class F>
__device__ void accumulate_tree_step(int64_t* px, int64_t* py, int64_t* pz, const int64_t* counts,
                                     const int64_t* first, const int64_t* runs, int64_t t, int nwin, int m, int b,
                                     int sub, int level) {
  int64_t j = t % m, w = t / m % nwin;
  int64_t d = runs[w * m + j];
  if (d >= b) return;
  int64_t k = w * b + d, i = j - first[k], nsub = (counts[k] + sub - 1) / sub, half = (int64_t)1 << level;
  if ((i & (2 * half - 1)) != 0 || i + half >= nsub) return;
  store_jac(px, py, pz, t, jac_add(load_jac<F>(px, py, pz, t), load_jac<F>(px, py, pz, t + half)));
}

// K3 collect, thread t = (s * nwin + w) * b + d
template <class F>
__device__ void accumulate_collect(const int64_t* px, const int64_t* py, const int64_t* pz, const int64_t* counts,
                                   const int64_t* first, int64_t* ox, int64_t* oy, int64_t* oz, int64_t t, int nwin,
                                   int m, int b) {
  int64_t row = t / b, k = row % nwin * b + t % b;
  store_jac(ox, oy, oz, t, counts[k] > 0 ? load_jac<F>(px, py, pz, row * m + first[k]) : jac_infinity<F>());
}

// K4 range pass, thread j of the block of row = s * nwin + w (nt threads):
// run = R_j, the sum of its m = b / nt buckets, and wsum = W_j = sum_i i
// S_(j m + i), by the running sum over i = m - 1 .. 0; the row's lane
// `skip` (-1: none) counts as infinity
template <class F>
__device__ void reduce_range(const int64_t* bx, const int64_t* by, const int64_t* bz, int64_t row, int b, int nt,
                             int j, Jac<F>& run, Jac<F>& wsum, int64_t skip = -1) {
  int m = b / nt;
  int64_t base = row * b + (int64_t)j * m, own = skip - (int64_t)j * m;
  run = jac_infinity<F>();
  wsum = jac_infinity<F>();
  for (int i = m - 1; i >= 1; --i) {
    if (i != own) run = jac_add(run, load_jac<F>(bx, by, bz, base + i));
    wsum = jac_add(wsum, run);
  }
  if (own != 0) run = jac_add(run, load_jac<F>(bx, by, bz, base));
}

// K4 suffix-scan step k (1, 2, 4, .. < nt) of thread j: its value plus the
// one k threads up, as all threads held them before the step
template <class F>
__device__ Jac<F> reduce_suffix_step(const Jac<F>& own, const Jac<F>* held, int j, int k, int nt) {
  return j + k < nt ? jac_add(own, held[j + k]) : own;
}

// K4: thread j's term W_j + m Suf_j (Suf_0 has weight 0); signed, thread
// 0's is W_0 + Suf_0 (the total: every lane's weight one more)
template <class F>
__device__ Jac<F> reduce_weigh(const Jac<F>& suffix, const Jac<F>& wsum, int j, int m, bool sgn = false) {
  if (!j) return sgn ? jac_add(wsum, suffix) : wsum;
  Jac<F> p = suffix;
  for (int k = m; k > 1; k >>= 1) p = jac_double(p);
  return jac_add(wsum, p);
}

// K4 tree step: thread j < stride adds the term `stride` threads up
template <class F>
__device__ void reduce_tree_step(Jac<F>* terms, int j, int stride) {
  if (j < stride) terms[j] = jac_add(terms[j], terms[j + stride]);
}

// K5's group law as levels: the products of a doubling (three levels) and
// of an add (five) that do not depend on each other, computed by a
// `Products` policy, prod(out, a, b): out[k] = a[k] b[k] for one level.
// SerialProducts runs them in order on one thread (the host tests);
// WarpProducts gives every product a lane of the set's warp. The values are
// those of field.cuh's jac_double and jac_add, operation for operation.
struct SerialProducts {
  template <class F, int N>
  __device__ void operator()(F (&out)[N], const F (&a)[N], const F (&b)[N]) const {
    for (int k = 0; k < N; ++k) out[k] = mul(a[k], b[k]);
  }
};

// dbl-2009-l
template <class F, class Products>
__device__ Jac<F> jac_double_levels(const Jac<F>& p, const Products& prod) {
  F a1[3] = {p.x, p.y, p.z}, b1[3] = {p.x, p.y, p.y}, o1[3];
  prod(o1, a1, b1);  // A = X^2, B = Y^2, Z Y
  F e = add(dbl(o1[0]), o1[0]);
  F a2[3] = {o1[1], add(p.x, o1[1]), e}, o2[3];
  prod(o2, a2, a2);  // C = B^2, (X + B)^2, E^2
  F d = dbl(sub(sub(o2[1], o1[0]), o2[0]));
  F x3 = sub(o2[2], dbl(d));
  F a3[1] = {sub(d, x3)}, b3[1] = {e}, o3[1];
  prod(o3, a3, b3);  // (D - X3) E
  return {x3, sub(o3[0], dbl(dbl(dbl(o2[0])))), dbl(o1[2])};
}

// add-2007-bl with jac_add's exceptional cases
template <class F, class Products>
__device__ Jac<F> jac_add_levels(const Jac<F>& p, const Jac<F>& q, const Products& prod) {
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  F a1[4] = {p.z, q.z, p.y, q.y}, b1[4] = {p.z, q.z, q.z, p.z}, o1[4];
  prod(o1, a1, b1);  // Z1^2, Z2^2, Y1 Z2, Y2 Z1
  F a2[4] = {p.x, q.x, o1[2], o1[3]}, b2[4] = {o1[1], o1[0], o1[1], o1[0]}, o2[4];
  prod(o2, a2, b2);  // U1, U2, S1, S2
  bool eq_x = eq(o2[0], o2[1]);
  if (eq_x && eq(o2[2], o2[3])) return jac_double_levels(p, prod);  // P == Q
  F h = sub(o2[1], o2[0]), r = dbl(sub(o2[3], o2[2]));
  F a3[3] = {dbl(h), r, add(p.z, q.z)}, o3[3];
  prod(o3, a3, a3);  // I = (2H)^2, r^2, (Z1 + Z2)^2
  F a4[3] = {h, o2[0], sub(sub(o3[2], o1[0]), o1[1])}, b4[3] = {o3[0], o3[0], h}, o4[3];
  prod(o4, a4, b4);  // J, V, Z3
  F x3 = sub(sub(o3[1], o4[0]), dbl(o4[1]));
  F a5[2] = {sub(o4[1], x3), o2[2]}, b5[2] = {r, o4[0]}, o5[2];
  prod(o5, a5, b5);  // (V - X3) r, S1 J
  F z3 = o4[2];
  if (eq_x) z3 = sub(z3, z3);  // P == -Q: infinity, x3 and y3 as computed
  return {x3, sub(o5[0], dbl(o5[1])), z3};
}

// K5, set s: sum_w 2^(c w) (T_w + e_w H_w) as one chain from infinity over
// every window, most significant first: c steps per window, each a doubling
// (skipped while the point is at infinity, so the chain starts at the first
// finite term) and the add of H_w where its bit of e_w is set, then the add
// of T_w. H_w = (bx, by, bz)[(s nwin + w) b + lanes[s nwin + w]] and e_w =
// weights[s nwin + w] (the fold; absent without weights). An add into
// infinity returns its other operand. A window without the fold takes the
// loop of the kernel before the fold: a finite point stays finite under
// doubling (the groups have no point of order 2), so one test covers its c
// doublings; the fold's loop reads H_w at each add rather than hold it.
template <class F, class Products>
__device__ Jac<F> combine_windows_set(const int64_t* sx, const int64_t* sy, const int64_t* sz, int64_t s, int nwin,
                                      int c, const Products& prod, const int64_t* bx = nullptr,
                                      const int64_t* by = nullptr, const int64_t* bz = nullptr,
                                      const int64_t* lanes = nullptr, const int64_t* weights = nullptr, int b = 0) {
  Jac<F> p = jac_infinity<F>();
  for (int w = nwin - 1; w >= 0; --w) {
    int64_t row = s * nwin + w, e = weights ? weights[row] : 0;
    if (e) {
      for (int i = c - 1; i >= 0; --i) {
        if (!is_zero(p.z)) p = jac_double_levels(p, prod);
        if ((e >> i) & 1) p = jac_add_levels(p, load_jac<F>(bx, by, bz, row * b + lanes[row]), prod);
      }
    } else if (!is_zero(p.z)) {
      for (int k = 0; k < c; ++k) p = jac_double_levels(p, prod);
    }
    p = jac_add_levels(p, load_jac<F>(sx, sy, sz, row), prod);
  }
  return p;
}

// K5's count of the fold (`folds`, given with the fold table only): a set
// folds where a window's weight is nonzero. The launch adds 1 to folds[0]
// for every set that folds, and 1 to folds[1] at its first such set.
__device__ inline bool set_takes_fold(const int64_t* weights, int64_t s, int nwin) {
  for (int w = 0; w < nwin; ++w)
    if (weights[s * nwin + w]) return true;
  return false;
}

// 0: set s folds in no window; 1: it folds; 3: it folds and no set below it does
__device__ inline int set_folds(const int64_t* weights, int64_t s, int nwin) {
  if (!set_takes_fold(weights, s, nwin)) return 0;
  for (int64_t t = 0; t < s; ++t)
    if (set_takes_fold(weights, t, nwin)) return 1;
  return 3;
}

#ifdef __CUDACC__
namespace {

// one product a lane of the warp (Fq2: each of Karatsuba's three Fq
// products a lane), every result broadcast to all lanes with __shfl_sync:
// a level costs one product's latency and 8 shuffles a product. Lanes past
// the level's products compute a spare copy of product 0. Every lane of the
// warp must call it (the full mask). G1 inlines its product (0.58 against
// 0.71 ms at the verify chunk on an H100); G2, whose levels carry more code,
// was slower so (1.51 against 1.40 ms) and calls it.
struct WarpProducts {
  template <int N>
  __device__ void operator()(Fp (&out)[N], const Fp (&a)[N], const Fp (&b)[N]) const {
    int lane = threadIdx.x & 31;
    Fp x = a[0], y = b[0];
#pragma unroll
    for (int k = 1; k < N; ++k)
      if (lane == k) x = a[k], y = b[k];
    Fp r = mul_inline(x, y);
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) out[k].v[i] = __shfl_sync(0xffffffffu, r.v[i], k);
  }

  // lane 3k + j: v0 = a0 b0 (j = 0), v1 = a1 b1 (1), (a0 + a1)(b0 + b1) (2)
  // of product k; then c0 = v0 - v1, c1 = t - v0 - v1 (field.cuh's Karatsuba)
  template <int N>
  __device__ void operator()(Fp2 (&out)[N], const Fp2 (&a)[N], const Fp2 (&b)[N]) const {
    int lane = threadIdx.x & 31;
    Fp x = a[0].c0, y = b[0].c0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (lane == 3 * k) x = a[k].c0, y = b[k].c0;
      if (lane == 3 * k + 1) x = a[k].c1, y = b[k].c1;
      if (lane == 3 * k + 2) x = add(a[k].c0, a[k].c1), y = add(b[k].c0, b[k].c1);
    }
    Fp r = mul(x, y);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      Fp v[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j].v[i] = __shfl_sync(0xffffffffu, r.v[i], 3 * k + j);
      out[k] = {sub(v[0], v[1]), sub(sub(v[2], v[0]), v[1])};
    }
  }
};

constexpr int kThreads = 128;
constexpr int kReduceThreads = 256;
static_assert(kReduceThreads * sizeof(Jac<Fp2>) <= 48 * 1024, "K4's shared points must fit the default 48 KB");

// Signed: the signed mode's instance (splits read); the unsigned one
// compiles without the negation
template <class F, bool Signed>
__global__ void __launch_bounds__(kThreads)
bucket_accumulate_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y, const bool* __restrict__ inf,
                         const int64_t* __restrict__ shifts, const int64_t* __restrict__ orders,
                         const int64_t* __restrict__ starts, const int64_t* __restrict__ counts,
                         const int64_t* __restrict__ first, const int64_t* __restrict__ runs,
                         const int64_t* __restrict__ splits, int64_t* __restrict__ px, int64_t* __restrict__ py,
                         int64_t* __restrict__ pz, int64_t total, int n, int nwin, int m, int b, int sub) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total)
    accumulate_subrun<F>(x, y, inf, shifts, orders, starts, counts, first, runs, px, py, pz, t, n, nwin, m, b, sub,
                         Signed ? splits : nullptr);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
bucket_accumulate_tree_kernel(int64_t* __restrict__ px, int64_t* __restrict__ py, int64_t* __restrict__ pz,
                              const int64_t* __restrict__ counts, const int64_t* __restrict__ first,
                              const int64_t* __restrict__ runs, int64_t total, int nwin, int m, int b, int sub,
                              int level) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) accumulate_tree_step<F>(px, py, pz, counts, first, runs, t, nwin, m, b, sub, level);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
bucket_accumulate_collect_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                                 const int64_t* __restrict__ pz, const int64_t* __restrict__ counts,
                                 const int64_t* __restrict__ first, int64_t* __restrict__ ox,
                                 int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t total, int nwin, int m,
                                 int b) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) accumulate_collect<F>(px, py, pz, counts, first, ox, oy, oz, t, nwin, m, b);
}

// one block per (set, window), blockDim.x = nt threads, nt Jacobian points
// of dynamic shared memory; skips (may be null) the lane each row leaves out
template <class F>
__global__ void __launch_bounds__(kReduceThreads)
bucket_reduce_kernel(const int64_t* __restrict__ bx, const int64_t* __restrict__ by,
                     const int64_t* __restrict__ bz, const int64_t* __restrict__ skips, int64_t* __restrict__ ox,
                     int64_t* __restrict__ oy, int64_t* __restrict__ oz, int b, bool sgn) {
  extern __shared__ __align__(16) unsigned char smem[];
  Jac<F>* held = reinterpret_cast<Jac<F>*>(smem);
  int nt = blockDim.x, j = threadIdx.x;
  int64_t row = blockIdx.x;
  Jac<F> run, wsum;
  reduce_range<F>(bx, by, bz, row, b, nt, j, run, wsum, skips ? skips[row] : -1);
  held[j] = run;
  __syncthreads();
  for (int k = 1; k < nt; k <<= 1) {
    run = reduce_suffix_step<F>(run, held, j, k, nt);
    __syncthreads();
    held[j] = run;
    __syncthreads();
  }
  held[j] = reduce_weigh<F>(run, wsum, j, b / nt, sgn);
  __syncthreads();
  for (int stride = nt / 2; stride >= 1; stride >>= 1) {
    reduce_tree_step<F>(held, j, stride);
    __syncthreads();
  }
  if (j == 0) store_jac(ox, oy, oz, row, held[0]);
}

// one warp (a block of 32 threads) per set: every lane holds the whole
// state, so the branches are the warp's and no lane ever waits on a mask;
// bx .. folds null without the fold
template <class F>
__global__ void __launch_bounds__(32)
combine_windows_kernel(const int64_t* __restrict__ sx, const int64_t* __restrict__ sy,
                       const int64_t* __restrict__ sz, const int64_t* __restrict__ bx, const int64_t* __restrict__ by,
                       const int64_t* __restrict__ bz, const int64_t* __restrict__ lanes,
                       const int64_t* __restrict__ weights, unsigned long long* __restrict__ folds,
                       int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz, int nwin, int c,
                       int b) {
  int64_t s = blockIdx.x;
  Jac<F> p = combine_windows_set<F>(sx, sy, sz, s, nwin, c, WarpProducts(), bx, by, bz, lanes, weights, b);
  if (threadIdx.x == 0) {
    store_jac(ox, oy, oz, s, p);
    int f = folds ? set_folds(weights, s, nwin) : 0;
    if (f) atomicAdd(&folds[0], 1ull);
    if (f == 3) atomicAdd(&folds[1], 1ull);
  }
}

inline int blocks_for(int64_t threads) { return (int)((threads + kThreads - 1) / kThreads); }

template <class F>
int launch_accumulate(const void* x, const void* y, const void* inf, const void* shifts, const void* orders,
                      const void* starts, const void* counts, const void* first, const void* runs,
                      const void* splits, void* px, void* py, void* pz, void* ox, void* oy, void* oz, int nsets,
                      int n, int nwin, int m, int b, int sub, int levels, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int64_t parts = (int64_t)nsets * nwin * m, buckets = (int64_t)nsets * nwin * b;
  if (parts <= 0 || buckets <= 0) return (int)cudaGetLastError();
  if (splits)
    bucket_accumulate_kernel<F, true><<<blocks_for(parts), kThreads, 0, st>>>(
        (const int64_t*)x, (const int64_t*)y, (const bool*)inf, (const int64_t*)shifts, (const int64_t*)orders,
        (const int64_t*)starts, (const int64_t*)counts, (const int64_t*)first, (const int64_t*)runs,
        (const int64_t*)splits, (int64_t*)px, (int64_t*)py, (int64_t*)pz, parts, n, nwin, m, b, sub);
  else
    bucket_accumulate_kernel<F, false><<<blocks_for(parts), kThreads, 0, st>>>(
        (const int64_t*)x, (const int64_t*)y, (const bool*)inf, (const int64_t*)shifts, (const int64_t*)orders,
        (const int64_t*)starts, (const int64_t*)counts, (const int64_t*)first, (const int64_t*)runs, nullptr,
        (int64_t*)px, (int64_t*)py, (int64_t*)pz, parts, n, nwin, m, b, sub);
  int err = (int)cudaGetLastError();
  for (int level = 0; level < levels && !err; ++level) {
    bucket_accumulate_tree_kernel<F><<<blocks_for(parts), kThreads, 0, st>>>(
        (int64_t*)px, (int64_t*)py, (int64_t*)pz, (const int64_t*)counts, (const int64_t*)first,
        (const int64_t*)runs, parts, nwin, m, b, sub, level);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  bucket_accumulate_collect_kernel<F><<<blocks_for(buckets), kThreads, 0, st>>>(
      (const int64_t*)px, (const int64_t*)py, (const int64_t*)pz, (const int64_t*)counts, (const int64_t*)first,
      (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, buckets, nwin, m, b);
  return (int)cudaGetLastError();
}

template <class F>
int launch_reduce(const void* bx, const void* by, const void* bz, const void* skips, void* ox, void* oy, void* oz,
                  int nsets, int nwin, int b, int nt, int sgn, void* stream) {
  if (nt < 1 || nt > kReduceThreads || (nt & (nt - 1)) || b % nt) return (int)cudaErrorInvalidValue;
  int rows = nsets * nwin;
  if (rows > 0) {
    bucket_reduce_kernel<F><<<rows, nt, nt * sizeof(Jac<F>), (cudaStream_t)stream>>>(
        (const int64_t*)bx, (const int64_t*)by, (const int64_t*)bz, (const int64_t*)skips, (int64_t*)ox,
        (int64_t*)oy, (int64_t*)oz, b, sgn != 0);
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_combine(const void* sx, const void* sy, const void* sz, const void* bx, const void* by, const void* bz,
                   const void* lanes, const void* weights, void* folds, void* ox, void* oy, void* oz, int nsets,
                   int nwin, int c, int b, void* stream) {
  if (nsets > 0) {
    combine_windows_kernel<F><<<nsets, 32, 0, (cudaStream_t)stream>>>(
        (const int64_t*)sx, (const int64_t*)sy, (const int64_t*)sz, (const int64_t*)bx, (const int64_t*)by,
        (const int64_t*)bz, (const int64_t*)lanes, (const int64_t*)weights, (unsigned long long*)folds,
        (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, nwin, c, b);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (K3: after the first launch that fails, or the last). K3's px, py, pz are
// its (S, nwin, M) scratch partials; its splits, K4's skips and K5's bx ..
// folds may be null (the unsigned mode, no excluded lane, no fold); K5's
// folds is its two counters (set_folds).
#define P2_MSM_ENTRY_POINTS(G, F)                                                                                 \
  extern "C" int p2_bucket_accumulate_##G(const void* x, const void* y, const void* inf, const void* shifts,      \
                                          const void* orders, const void* starts, const void* counts,          \
                                          const void* first, const void* runs, const void* splits, void* px,   \
                                          void* py, void* pz, void* ox, void* oy, void* oz, int nsets, int n,  \
                                          int nwin, int m, int b, int sub, int levels, void* stream) {         \
    return launch_accumulate<F>(x, y, inf, shifts, orders, starts, counts, first, runs, splits, px, py, pz, ox,  \
                                oy, oz, nsets, n, nwin, m, b, sub, levels, stream);                            \
  }                                                                                                            \
  extern "C" int p2_bucket_reduce_##G(const void* bx, const void* by, const void* bz, const void* skips,          \
                                      void* ox, void* oy, void* oz, int nsets, int nwin, int b, int nt,        \
                                      int sgn, void* stream) {                                                 \
    return launch_reduce<F>(bx, by, bz, skips, ox, oy, oz, nsets, nwin, b, nt, sgn, stream);                   \
  }                                                                                                            \
  extern "C" int p2_combine_windows_##G(const void* sx, const void* sy, const void* sz, const void* bx,           \
                                        const void* by, const void* bz, const void* lanes,                     \
                                        const void* weights, void* folds, void* ox, void* oy, void* oz,        \
                                        int nsets, int nwin, int c, int b, void* stream) {                     \
    return launch_combine<F>(sx, sy, sz, bx, by, bz, lanes, weights, folds, ox, oy, oz, nsets, nwin, c, b,     \
                             stream);                                                                          \
  }

P2_MSM_ENTRY_POINTS(g1, Fp)
P2_MSM_ENTRY_POINTS(g2, Fp2)
#endif  // __CUDACC__
