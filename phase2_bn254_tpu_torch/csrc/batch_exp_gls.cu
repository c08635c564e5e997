// K10: unsigned GLS quad ladder for BN254 G2, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_gls (_batch_exp_gls_kernel): out[i] = k_i * Q_i with
// k_i = sum_c k_c L^c split by ops/gls.py `decompose` into four rows of 4-bit
// windows of |k_c| (17 each, most significant first) and one sign flag per
// component and lane. T[j] = j Q for j = 0..15 (T[0] = infinity); each
// window does 4 doublings, then for c = 0..3 adds psi^c(T[d_c]) (ladders.cuh
// psi_pow, applied to the gathered entry first) with y negated after psi
// for the lanes with k_c < 0, whatever the digit.
// In: x, y int64 (N, 2, 16) Montgomery affine ([c0, c1]); digits int64
// (4, W, N); negs int64 (4, N). Out: x, y, z int64 (N, 2, 16), Jacobian,
// Montgomery, fully reduced. The ceremony runs it for G2 under
// PHASE2_TPU_NO_SIGNED5 (ops/backend.py Ladders).
//
// What bounds it on the card: 32-bit integer multiply throughput, about
// 4,900 Fq products a point (17 windows of 4 doublings, psi, psi^2, psi^3
// and up to 4 adds, against K2's 14 windows of 5), and the per-thread table
// of 16 Fq2 Jacobian points (3 KB) in local memory, read four times per
// window. The design is K2's: one point per thread, the table in local
// memory.
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ladders.cuh"

// Point i of the batch (W = nw windows).
__device__ void batch_exp_gls_point(const int64_t* x, const int64_t* y, const int64_t* digits,
                                    const int64_t* negs, int64_t* ox, int64_t* oy, int64_t* oz, int i, int n,
                                    int nw) {
  Jac<Fp2> table[16];
  table[0] = jac_infinity<Fp2>();
  load_el(x + 32 * (int64_t)i, table[1].x);
  load_el(y + 32 * (int64_t)i, table[1].y);
  table[1].z = fp2_one();
  for (int k = 2; k < 16; ++k) table[k] = jac_add(table[k - 1], table[1]);  // k = 2 is Q + Q

  bool ng[4];
  for (int c = 0; c < 4; ++c) ng[c] = negs[(int64_t)c * n + i] != 0;
  Jac<Fp2> acc = jac_infinity<Fp2>();
  for (int w = 0; w < nw; ++w) {
    for (int s = 0; s < 4; ++s) acc = jac_double(acc);
    for (int c = 0; c < 4; ++c) {
      Jac<Fp2> e = psi_pow(c, table[(int)digits[((int64_t)c * nw + w) * n + i]]);
      if (ng[c]) e.y = neg(e.y);
      acc = jac_add(acc, e);
    }
  }
  store_jac(ox, oy, oz, (int64_t)i, acc);
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
batch_exp_gls_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                     const int64_t* __restrict__ digits, const int64_t* __restrict__ negs,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n,
                     int nw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_gls_point(x, y, digits, negs, ox, oy, oz, i, n, nw);
}

}  // namespace

// Launches K10 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_gls(const void* x, const void* y, const void* digits, const void* negs, void* ox,
                                void* oy, void* oz, int n, int nw, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_gls_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)digits, (const int64_t*)negs, (int64_t*)ox,
        (int64_t*)oy, (int64_t*)oz, n, nw);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
