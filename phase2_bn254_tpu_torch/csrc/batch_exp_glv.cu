// K7: unsigned GLV double ladder for BN254 G1, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_glv (_batch_exp_glv_kernel): out[i] = k_i * P_i with
// k_i = k1 + k2 * lambda split by ops/glv.py `decompose` into 4-bit windows
// of |k1| and |k2| (33 each, most significant first) and one sign flag per
// component and lane. T[j] = j P for j = 0..15 (T[0] = infinity) and the
// beta x of each entry, phi(x, y) = (beta x, y); each window does 4
// doublings, then adds s1 T[d1] and s2 phi(T[d2]), where s_c = -1 for the
// lanes with k_c < 0 whatever the digit (T[0] negated is still infinity).
// The per-point code is a template over the field type, as the TPU kernel is
// generic in its limb count; it is instantiated here for BN254 Fq and for
// BLS12-381 Fq (K7-BLS: the JAX package's bls12_381/device.py:209
// pallas_batch_mul_glv runs the same TPU kernel with its 24-limb field
// constants and BLS beta, on the split of bls12_381/glv.py's basis).
// In: x, y int64 (N, 16) Montgomery affine; d1, d2 int64 (W, N); negs int64
// (2, N). Out: x, y, z int64 (N, 16), Jacobian, Montgomery, fully reduced.
// The ceremony runs it for G1 under PHASE2_TPU_NO_SIGNED5 (ops/backend.py
// Ladders), the phase-2 QAP terms included. K7-BLS: x, y, out int64 (N, 24),
// R = 2^384; the BLS12-381 device path (bls12_381/device.py glv_ladder) runs
// it.
//
// What bounds it on the card: 32-bit integer multiply throughput, about
// 2,100 Fq products a point on uniform scalars (33 windows of 4 doublings
// and up to 2 adds, against K1's 26 of 5 and 2), and the per-thread table
// of 16 Jacobian points plus 16 beta x planes (2 KB) in local memory, read
// twice per window. The design keeps K1's one point per thread (no
// cross-thread carries, the table in local memory) and does only the work
// each thread's digits ask for:
// * T[2..15] is built only where a digit above 1 occurs in d1 or d2, by
//   one doubling and 13 mixed adds of the affine P (11 products each where
//   a general add takes 16; the values of general adds, every one fully
//   reduced), and beta x only for the entries that d2 reaches: a scalar
//   whose components are 0 and 1 (1, r - 1, the bulk of a circuit's QAP
//   terms) builds nothing;
// * each thread starts at its own first window with a nonzero digit in d1
//   or d2, with no doublings before it; a thread with none runs the last
//   window alone, whose adds of +-T[0] and +-phi(T[0]) leave the limbs the
//   full ladder leaves (an add into infinity returns its other operand);
// * a zero digit costs no add once the accumulator is finite (the add
//   would return it unchanged); while it is at infinity the add of +-T[0]
//   runs, as the full ladder's, and sets its limbs.
// The limbs are the full 33-window ladder's in every thread. K7-BLS does
// the same work on 12 x 32-bit limbs (588 multiplies an Fq product, 2.2x
// BN254's) with a table of 16 points of 144 bytes and 16 beta x of 48
// (3 KB).
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// Point i of the batch (W = nw windows); beta in Montgomery form.
template <class F>
__device__ void batch_exp_glv_point(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                                    const int64_t* negs, const F& beta, int64_t* ox, int64_t* oy,
                                    int64_t* oz, int i, int n, int nw) {
  int first = nw - 1, top = 0;  // the first window with a nonzero digit (the last if none has), the largest digit
  uint32_t reach2 = 0;  // bit j: d2 holds the digit j
  for (int w = nw - 1; w >= 0; --w) {
    const int da = (int)d1[(int64_t)w * n + i], db = (int)d2[(int64_t)w * n + i];
    if (da | db) first = w;
    top = da > top ? da : top;
    top = db > top ? db : top;
    reach2 |= 1u << db;
  }
  Jac<F> table[16];
  F beta_x[16];
  F px, py;
  load_el(x + kDigits<F> * (int64_t)i, px);
  load_el(y + kDigits<F> * (int64_t)i, py);
  table[0] = jac_infinity<F>();
  beta_x[0] = table[0].x;  // zero
  table[1] = {px, py, table[0].y};  // z = one
  if (top >= 2) {
    table[2] = jac_double(table[1]);
    for (int k = 3; k < 16; ++k) table[k] = jac_madd(table[k - 1], px, py);
  }
  for (int k = 1; k < 16; ++k)
    if ((reach2 >> k) & 1) beta_x[k] = mul(table[k].x, beta);

  const bool neg1 = negs[i] != 0, neg2 = negs[n + i] != 0;
  Jac<F> acc = jac_infinity<F>();
  for (int w = first; w < nw; ++w) {
    if (w > first)
      for (int s = 0; s < 4; ++s) acc = jac_double(acc);
    const int da = (int)d1[(int64_t)w * n + i];
    if (da != 0 || is_zero(acc.z)) {
      Jac<F> e = table[da];
      if (neg1) e.y = neg(e.y);
      acc = jac_add(acc, e);
    }
    const int db = (int)d2[(int64_t)w * n + i];
    if (db != 0 || is_zero(acc.z)) {
      Jac<F> e = {beta_x[db], table[db].y, table[db].z};
      if (neg2) e.y = neg(e.y);
      acc = jac_add(acc, e);
    }
  }
  store_jac(ox, oy, oz, (int64_t)i, acc);
}

// Point i of a BLS12-381 batch.
__device__ void batch_exp_bls_glv_point(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                                        const int64_t* negs, int64_t* ox, int64_t* oy, int64_t* oz, int i, int n,
                                        int nw) {
  batch_exp_glv_point<BFp>(x, y, d1, d2, negs, bfp_from_const(BLS_GLV_BETA), ox, oy, oz, i, n, nw);
}

#ifdef __CUDACC__
namespace {

// K7: 64 threads a block (236 registers, no spill): on an NVIDIA H100 80GB HBM3 at 700 W as fast as 128 at
// 2^16 uniform scalars and 5% faster on `new`'s terms of coefficient 1, 1% faster than 256 at 2^16; the table
// by general adds 0.3% slower (scripts/bench_shapes.py K7). K7-BLS: 128 threads (255 registers, 360 bytes of
// spill), within 0.1% of 64 and 3% faster than 256; the general-add table 1% slower (bench_shapes.py K7-BLS).
constexpr int kThreads = 64;
constexpr int kBlsThreads = 128;

__global__ void __launch_bounds__(kThreads)
batch_exp_glv_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                     const int64_t* __restrict__ d1, const int64_t* __restrict__ d2,
                     const int64_t* __restrict__ negs, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                     int64_t* __restrict__ oz, int n, int nw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_glv_point<Fp>(x, y, d1, d2, negs, fp_from_const(GLV_BETA), ox, oy, oz, i, n, nw);
}

__global__ void __launch_bounds__(kBlsThreads)
batch_exp_bls_glv_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                         const int64_t* __restrict__ d1, const int64_t* __restrict__ d2,
                         const int64_t* __restrict__ negs, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                         int64_t* __restrict__ oz, int n, int nw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_bls_glv_point(x, y, d1, d2, negs, ox, oy, oz, i, n, nw);
}

}  // namespace

// Launches K7 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_glv(const void* x, const void* y, const void* d1, const void* d2, const void* negs,
                                void* ox, void* oy, void* oz, int n, int nw, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_glv_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)d1, (const int64_t*)d2, (const int64_t*)negs,
        (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, n, nw);
  }
  return (int)cudaGetLastError();
}

// Launches K7-BLS on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_bls_glv(const void* x, const void* y, const void* d1, const void* d2, const void* negs,
                                    void* ox, void* oy, void* oz, int n, int nw, void* stream) {
  if (n > 0) {
    int blocks = (n + kBlsThreads - 1) / kBlsThreads;
    batch_exp_bls_glv_kernel<<<blocks, kBlsThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)d1, (const int64_t*)d2, (const int64_t*)negs,
        (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, n, nw);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
