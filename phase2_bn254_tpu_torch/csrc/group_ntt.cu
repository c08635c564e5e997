// N1 and N2: the group NTT's butterfly stage and its Jacobian ladder, G1 and
// G2, one thread per pair (N1) or per point (N2).
//
// Replaces XLA glue of the JAX package, not a Pallas kernel: the group NTT
// of prepare_phase2 (phase2_bn254_tpu/ops/ntt.py _group_stage with
// _jac_scalar_mul, ops/ntt.py:133-147 and :224-260, streamed through
// ceremony/streaming.py group_intt_streamed), where every butterfly's
// twiddle is a full point-scalar ladder over a Jacobian base.
//
// N1 group_ntt_stage: radix-2 stage s (half = 2^(s-1)) of a DIT DFT over
//   rows of C = 2^log2c Jacobian points, in place. Pair p of row `row`, idx
//   = p mod C/2, j = idx mod half:
//     e = row C + (idx / half) 2 half + j, o = e + half, w = tw[j C / (2 half)]
//     (a, b) = (P[e], P[o]);  t = w b;  P[e] = a + t;  P[o] = a - t
//   tw: the row length's canonical twiddles w_C^j, j < C/2 (the caller's
//   Domain(log2c).twiddles_canonical).
// N2 jac_scalar_mul: P[i] = k_i P[i] in place, k_i canonical (k[i], or k[0]
//   for every point where the scalar is broadcast): the four-step's
//   inter-row twiddles and the iNTT's 1/N.
// In: x, y, z int64 (N, 16) (G1) or (N, 2, 16) (G2), Jacobian, Montgomery,
// fully reduced, any point (infinity included); scalars int64 (., 16)
// canonical Fr digits. Out: the same arrays.
//
// The ladder (`jac_ladder`) is K8's and K9's windowed ladder
// (ladders.cuh windowed_ladder_point) over a Jacobian base: k above (r -
// 1)/2 runs as (r - k)(-B); each thread starts at its first nonzero 4-bit
// window with acc = T[d]; after it 4 doublings a window and an add of T[d]
// for a nonzero digit; T[2..15] (T[j] = j B, by general adds: B is
// Jacobian) only where a digit above 1 occurs. So a twiddle of 1 (all of
// stage 1, the first pair of every block) costs no doubling, and k = 0
// gives (0, 1, 0). The adds are field.cuh's complete ones: a + t with a ==
// t doubles, a == -t gives infinity, an infinity operand returns the other
// (real inputs hit these: the initial challenge's vectors of equal points).
// ops/ntt.py's plain versions take the same steps, so the limbs agree with
// theirs, infinities included.
//
// What bounds it on the card: 32-bit integer multiply throughput, some
// 2,900 Fq products a ladder (252 doublings of 7, up to 63 adds of 16, the
// table's 14 adds) on G1, as K8; the butterfly's two adds are 1% of it.
// The design is K8's and K9's: one ladder a thread, the table (up to 16
// Jacobian points, 1.5 KB on G1, 3 KB on G2) in local memory, no
// cross-thread work. A stage is one launch over every row of the batch, so
// a degree-2^m iNTT of V stacked vectors is m launches and one N2.
//
// Outside nvcc (no __CUDACC__) only the per-pair and per-point functions
// are compiled, so a host C++ compiler can run them on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// k B for a Jacobian base B and canonical scalar digits k (16 x 16 bits)
template <class F>
__device__ Jac<F> jac_ladder(const Jac<F>& base, const int64_t* k) {
  Fr s = load_limbs<Fr>(k);
  Jac<F> table[16];
  table[1] = base;
  int64_t borrow = 0;  // (r - 1)/2 - k < 0: k above (r - 1)/2
#pragma unroll
  for (int l = 0; l < 8; ++l) borrow = ((int64_t)FR_HALF[l] - (int64_t)s.v[l] + borrow) >> 32;
  if (borrow < 0) {
    int64_t b = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int64_t t = (int64_t)FR_P[l] - (int64_t)s.v[l] + b;
      s.v[l] = (uint32_t)t;
      b = t >> 32;
    }
    table[1].y = neg(table[1].y);
  }
  int first = 0, top = 0;  // the first nonzero window (0 if none is), the largest digit
  for (int w = 0; w < 64; ++w) {  // window w holds bits 4w .. 4w + 3
    const int d = (int)((s.v[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (d != 0) first = w;
    top = d > top ? d : top;
  }
  if (top >= 2)
    for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], table[1]);  // j = 2 doubles

  const int d0 = (int)((s.v[first >> 3] >> (4 * (first & 7))) & 0xF);
  Jac<F> acc = d0 == 0 ? jac_infinity<F>() : table[d0];
  for (int w = first - 1; w >= 0; --w) {
    for (int t = 0; t < 4; ++t) acc = jac_double(acc);
    const int d = (int)((s.v[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (d != 0) acc = jac_add(acc, table[d]);
  }
  return acc;
}

// N1, pair p of a launch over rows of 2^log2c points, stage s
template <class F>
__device__ void group_ntt_pair(int64_t* x, int64_t* y, int64_t* z, const int64_t* tw, int log2c, int s,
                               int64_t p) {
  const int64_t row = p >> (log2c - 1), idx = p & ((int64_t(1) << (log2c - 1)) - 1);
  const int64_t half = int64_t(1) << (s - 1), j = idx & (half - 1);
  const int64_t e = (row << log2c) + ((idx >> (s - 1)) << s) + j, o = e + half;
  Jac<F> t = jac_ladder(load_jac<F>(x, y, z, o), tw + 16 * (j << (log2c - s)));
  const Jac<F> a = load_jac<F>(x, y, z, e);  // after the ladder: not live across it
  store_jac(x, y, z, e, jac_add(a, t));
  t.y = neg(t.y);
  store_jac(x, y, z, o, jac_add(a, t));
}

// N2, point i
template <class F>
__device__ void jac_scalar_mul_point(int64_t* x, int64_t* y, int64_t* z, const int64_t* k, int per_lane,
                                     int64_t i) {
  store_jac(x, y, z, i, jac_ladder(load_jac<F>(x, y, z, i), k + (per_lane ? 16 * i : 0)));
}

#ifdef __CUDACC__
namespace {

// 128 threads a block, as K8 and K9 (their bench_shapes sweeps found 128
// best or within 1% of the best for this ladder)
constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
group_ntt_stage_kernel(int64_t* x, int64_t* y, int64_t* z, const int64_t* __restrict__ tw, int log2c, int s,
                       int64_t pairs) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < pairs) group_ntt_pair<F>(x, y, z, tw, log2c, s, p);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
jac_scalar_mul_kernel(int64_t* x, int64_t* y, int64_t* z, const int64_t* __restrict__ k, int per_lane,
                      int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) jac_scalar_mul_point<F>(x, y, z, k, per_lane, i);
}

template <class F>
int launch_stage(void* x, void* y, void* z, const void* tw, int rows, int log2c, int s, void* stream) {
  if (log2c < 1 || s < 1 || s > log2c || rows < 0) return (int)cudaErrorInvalidValue;
  const int64_t pairs = (int64_t)rows << (log2c - 1);
  if (pairs > 0)
    group_ntt_stage_kernel<F><<<(unsigned)((pairs + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (int64_t*)x, (int64_t*)y, (int64_t*)z, (const int64_t*)tw, log2c, s, pairs);
  return (int)cudaGetLastError();
}

template <class F>
int launch_scalar_mul(void* x, void* y, void* z, const void* k, int n, int per_lane, void* stream) {
  if (n > 0)
    jac_scalar_mul_kernel<F><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (int64_t*)x, (int64_t*)y, (int64_t*)z, (const int64_t*)k, per_lane, n);
  return (int)cudaGetLastError();
}

}  // namespace

// N1: stage s over `rows` rows of 2^log2c points on `stream`, in place.
// Each returns cudaGetLastError() after the launch.
extern "C" int p2_group_ntt_stage_g1(void* x, void* y, void* z, const void* tw, int rows, int log2c, int s,
                                     void* stream) {
  return launch_stage<Fp>(x, y, z, tw, rows, log2c, s, stream);
}

extern "C" int p2_group_ntt_stage_g2(void* x, void* y, void* z, const void* tw, int rows, int log2c, int s,
                                     void* stream) {
  return launch_stage<Fp2>(x, y, z, tw, rows, log2c, s, stream);
}

// N2: n points times their scalars (per_lane) or k[0] (not per_lane) on
// `stream`, in place.
extern "C" int p2_jac_scalar_mul_g1(void* x, void* y, void* z, const void* k, int n, int per_lane, void* stream) {
  return launch_scalar_mul<Fp>(x, y, z, k, n, per_lane, stream);
}

extern "C" int p2_jac_scalar_mul_g2(void* x, void* y, void* z, const void* k, int n, int per_lane, void* stream) {
  return launch_scalar_mul<Fp2>(x, y, z, k, n, per_lane, stream);
}
#endif  // __CUDACC__
