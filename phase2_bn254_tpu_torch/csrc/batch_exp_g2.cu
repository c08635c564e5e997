// K2: signed GLS quad ladder for BN254 G2, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_gls_signed (_batch_exp_gls_signed_kernel): out[i] =
// k_i * Q_i with k_i = sum_c k_c L^c split by ops/gls.py into four rows of
// signed base-32 digits in [-16, 16], most significant window first. Each
// window does 5 doublings, then for c = 0..3 adds sign(d_c) psi^c(T[|d_c|]),
// T[j] = j Q. psi^c (ladders.cuh psi_pow) is applied to the gathered entry
// first and y is negated after it.
// In: x, y int64 (N, 2, 16) Montgomery affine ([c0, c1]); digits int64
// (4, W, N). Out: x, y, z int64 (N, 2, 16), Jacobian, Montgomery, reduced.
//
// What bounds it on the card: 32-bit integer multiply throughput (about
// 300 Fq2 products and 200 Fq2 squares per point) and the per-thread table
// of 17 Fq2 Jacobian points (3.3 KB) in local memory, read four times per
// window. The design keeps one point per thread and the table in local
// memory, as K1 does, and does the fewest multiplies this ladder allows:
// each Fq2 product and square is one call of field.cuh's fused routine
// (Karatsuba with lazy reduction: 656 and 528 32-bit multiplies, one
// conditional subtraction per component), the table 2Q..16Q is one doubling
// and 14 mixed adds of the affine Q (the values of general adds, every one
// fully reduced), and each thread's accumulator starts at its first window
// in which any of the four digit rows is nonzero, with no doublings of
// infinity before it. A thread whose digits are all zero runs the last
// window alone, whose adds of psi^c(T[0]) leave the limbs the full ladder
// leaves (an add into infinity returns its other operand).
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ladders.cuh"

// Point i of the batch (W = nw windows).
__device__ void batch_exp_gls_signed_point(const int64_t* x, const int64_t* y, const int64_t* digits,
                                           int64_t* ox, int64_t* oy, int64_t* oz, int i, int n,
                                           int nw) {
  Jac<Fp2> table[17];
  Fp2 qx, qy;
  load_el(x + 32 * (int64_t)i, qx);
  load_el(y + 32 * (int64_t)i, qy);
  table[0] = jac_infinity<Fp2>();
  table[1] = {qx, qy, fp2_one()};
  table[2] = jac_double(table[1]);
  for (int k = 3; k < 17; ++k) table[k] = jac_madd(table[k - 1], qx, qy);

  int first = 0;  // the first window with a nonzero digit in any row; the last if none has
  for (; first < nw - 1; ++first) {
    int64_t any = 0;
    for (int c = 0; c < 4; ++c) any |= digits[((int64_t)c * nw + first) * n + i];
    if (any) break;
  }
  Jac<Fp2> acc = jac_infinity<Fp2>();
  for (int w = first; w < nw; ++w) {
    if (w > first)
      for (int s = 0; s < 5; ++s) acc = jac_double(acc);
    for (int c = 0; c < 4; ++c) {
      int d = (int)digits[((int64_t)c * nw + w) * n + i];
      Jac<Fp2> e = psi_pow(c, table[d < 0 ? -d : d]);
      if (d < 0) e.y = neg(e.y);
      acc = jac_add(acc, e);
    }
  }
  store_el(ox + 32 * (int64_t)i, acc.x);
  store_el(oy + 32 * (int64_t)i, acc.y);
  store_el(oz + 32 * (int64_t)i, acc.z);
}

#ifdef __CUDACC__
namespace {

// 256 threads a block: on an H100 1.6% faster than 128 and 0.9% than 64;
// launch bounds asking for 3 blocks of 128 (5 of 64) cap the registers at
// 168 and spill, 25% slower (PERF.md; scripts/bench_k2_shape.py)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
batch_exp_gls_signed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                            const int64_t* __restrict__ digits, int64_t* __restrict__ ox,
                            int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n, int nw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_gls_signed_point(x, y, digits, ox, oy, oz, i, n, nw);
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_gls_signed(const void* x, const void* y, const void* digits, void* ox,
                                       void* oy, void* oz, int n, int nw, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_gls_signed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)digits, (int64_t*)ox,
        (int64_t*)oy, (int64_t*)oz, n, nw);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
