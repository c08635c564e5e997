// K1: signed GLV double ladder for BN254 G1, one thread per point, and
// K1-BLS, the same at BLS12-381 width.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_glv_signed (_batch_exp_glv_signed_kernel): out[i] =
// k_i * P_i with k_i = k1 + k2 * lambda split by ops/glv.py into signed
// base-32 digits d1, d2 in [-16, 16], most significant window first. Each
// window does 5 doublings, then adds sign(d1) T[|d1|] and sign(d2)
// phi(T[|d2|]), where T[j] = j P (T[0] = infinity) and phi(x, y) = (beta x, y).
// In: x, y int64 (N, 16) Montgomery affine; d1, d2 int64 (W, N). Out:
// x, y, z int64 (N, 16), Jacobian, Montgomery, fully reduced. The per-point
// code is a template over the field type with beta its argument, as the TPU
// kernel is generic in its limb count: K1-BLS is its BLS12-381 instance
// (the JAX package's bls12_381/device.py:238 pallas_batch_mul_glv_signed
// runs the same TPU kernel with its 24-limb field constants and BLS beta):
// x, y, out int64 (N, 24), R = 2^384, digits of bls12_381/glv.py's split,
// 26 windows as at BN254 (bls12_381/device.py glv_signed_ladder).
//
// What bounds it on the card: 32-bit integer multiply throughput (about
// 1900 Montgomery products per point, half of them squares) and the
// per-thread table of 17 Jacobian points plus 17 beta x planes (2.2 KB),
// which lives in local memory and is read twice per window. The design keeps
// one point per thread (no cross-thread carries; 2^16 threads a chunk fill
// the card), calls field.cuh's PTX product and square out of line through
// the group operations (inlined, K1 was 40% slower on an H100: PERF.md, PR
// 9), and does the fewest products this ladder allows: the table
// 2P..16P is one doubling and 14 mixed adds of the affine P (11 products
// each, where a general add takes 16; the values are those of general adds,
// every one fully reduced), and each thread's accumulator starts at its
// first window with a nonzero digit, with no doublings of infinity before
// it (the same limbs: an add into infinity returns its other operand). The
// doubling branch for P + P and the cancellation case are per-thread
// branches rather than masks. K1-BLS does the same work on 12 x 32-bit
// limbs (588 multiplies an Fq product, 2.2x BN254's); its table of 17
// points of 144 bytes and 17 beta x of 48 (3.3 KB) stays in local memory.
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// Point i of the batch (W = nw windows), over the field F (Fp: BN254,
// BFp: BLS12-381); beta in Montgomery form.
template <class F>
__device__ void glv_signed_ladder_point(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                                        const F& beta, int64_t* ox, int64_t* oy, int64_t* oz, int i, int n,
                                        int nw) {
  Jac<F> table[17];
  F beta_x[17];
  F px, py;
  load_el(x + kDigits<F> * (int64_t)i, px);
  load_el(y + kDigits<F> * (int64_t)i, py);
  table[0] = jac_infinity<F>();
  beta_x[0] = table[0].x;  // zero
  table[1] = {px, py, table[0].y};  // z = one
  beta_x[1] = mul(px, beta);
  table[2] = jac_double(table[1]);
  beta_x[2] = mul(table[2].x, beta);
  for (int k = 3; k < 17; ++k) {
    table[k] = jac_madd(table[k - 1], px, py);
    beta_x[k] = mul(table[k].x, beta);
  }

  int first = 0;
  while (first < nw && d1[(int64_t)first * n + i] == 0 && d2[(int64_t)first * n + i] == 0) ++first;
  Jac<F> acc = jac_infinity<F>();
  for (int w = first; w < nw; ++w) {
    if (w > first)
      for (int s = 0; s < 5; ++s) acc = jac_double(acc);
    int da = (int)d1[(int64_t)w * n + i];
    Jac<F> e = table[da < 0 ? -da : da];
    if (da < 0) e.y = neg(e.y);
    acc = jac_add(acc, e);
    int db = (int)d2[(int64_t)w * n + i];
    int ab = db < 0 ? -db : db;
    e = {beta_x[ab], table[ab].y, table[ab].z};
    if (db < 0) e.y = neg(e.y);
    acc = jac_add(acc, e);
  }
  store_jac(ox, oy, oz, (int64_t)i, acc);
}

// Point i of a BN254 batch.
__device__ void batch_exp_glv_signed_point(const int64_t* x, const int64_t* y, const int64_t* d1,
                                           const int64_t* d2, int64_t* ox, int64_t* oy, int64_t* oz,
                                           int i, int n, int nw) {
  glv_signed_ladder_point<Fp>(x, y, d1, d2, fp_from_const(GLV_BETA), ox, oy, oz, i, n, nw);
}

// Point i of a BLS12-381 batch.
__device__ void batch_exp_bls_glv_signed_point(const int64_t* x, const int64_t* y, const int64_t* d1,
                                               const int64_t* d2, int64_t* ox, int64_t* oy, int64_t* oz,
                                               int i, int n, int nw) {
  glv_signed_ladder_point<BFp>(x, y, d1, d2, bfp_from_const(BLS_GLV_BETA), ox, oy, oz, i, n, nw);
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
batch_exp_glv_signed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                            const int64_t* __restrict__ d1, const int64_t* __restrict__ d2,
                            int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                            int64_t* __restrict__ oz, int n, int nw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_glv_signed_point(x, y, d1, d2, ox, oy, oz, i, n, nw);
}

__global__ void __launch_bounds__(kThreads)
batch_exp_bls_glv_signed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                const int64_t* __restrict__ d1, const int64_t* __restrict__ d2,
                                int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                int64_t* __restrict__ oz, int n, int nw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_bls_glv_signed_point(x, y, d1, d2, ox, oy, oz, i, n, nw);
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_glv_signed(const void* x, const void* y, const void* d1, const void* d2,
                                       void* ox, void* oy, void* oz, int n, int nw, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_glv_signed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)d1, (const int64_t*)d2,
        (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, n, nw);
  }
  return (int)cudaGetLastError();
}

// Launches K1-BLS on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_bls_glv_signed(const void* x, const void* y, const void* d1, const void* d2,
                                           void* ox, void* oy, void* oz, int n, int nw, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_bls_glv_signed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)d1, (const int64_t*)d2,
        (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, n, nw);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
