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
// What bounds it on the card: 32-bit integer multiply throughput (about
// 4,600 Fq products a point on uniform scalars: 17 windows of 4 doublings
// and up to 4 adds, psi, psi^2 and psi^3 of the nonzero digits, against
// K2's 14 windows of 5) and the per-thread table of 16 Fq2 Jacobian points
// (3 KB) in local memory, read four times per window. The design keeps
// K2's one point per thread and the table in local memory, and does only
// the work each thread's digits ask for:
// * T[2..15] is built only where a digit above 1 occurs in any of the four
//   rows, by one doubling and 13 mixed adds of the affine Q (the values of
//   general adds, every one fully reduced);
// * each thread starts at its own first window with a nonzero digit in any
//   row, with no doublings before it; a thread with none runs the last
//   window alone, whose adds of psi^c(T[0]) leave the limbs the full ladder
//   leaves (an add into infinity returns its other operand);
// * a zero digit costs no psi and no add once the accumulator is finite
//   (the add would return it unchanged); while it is at infinity they run,
//   as the full ladder's, and set its limbs.
// The limbs are the full 17-window ladder's in every thread.
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
  int first = nw - 1, top = 0;  // the first window with a nonzero digit in any row (the last if none has), the
                                // largest digit
  for (int w = nw - 1; w >= 0; --w) {
    int any = 0;
    for (int c = 0; c < 4; ++c) {
      const int d = (int)digits[((int64_t)c * nw + w) * n + i];
      any |= d;
      top = d > top ? d : top;
    }
    if (any) first = w;
  }
  Jac<Fp2> table[16];
  Fp2 qx, qy;
  load_el(x + 32 * (int64_t)i, qx);
  load_el(y + 32 * (int64_t)i, qy);
  table[0] = jac_infinity<Fp2>();
  table[1] = {qx, qy, fp2_one()};
  if (top >= 2) {
    table[2] = jac_double(table[1]);
    for (int k = 3; k < 16; ++k) table[k] = jac_madd(table[k - 1], qx, qy);
  }

  bool ng[4];
  for (int c = 0; c < 4; ++c) ng[c] = negs[(int64_t)c * n + i] != 0;
  Jac<Fp2> acc = jac_infinity<Fp2>();
  for (int w = first; w < nw; ++w) {
    if (w > first)
      for (int s = 0; s < 4; ++s) acc = jac_double(acc);
    for (int c = 0; c < 4; ++c) {
      const int d = (int)digits[((int64_t)c * nw + w) * n + i];
      if (d == 0 && !is_zero(acc.z)) continue;
      Jac<Fp2> e = psi_pow(c, table[d]);
      if (ng[c]) e.y = neg(e.y);
      acc = jac_add(acc, e);
    }
  }
  store_jac(ox, oy, oz, (int64_t)i, acc);
}

#ifdef __CUDACC__
namespace {

// 128 threads a block (255 registers): on an NVIDIA H100 80GB HBM3 at 700 W 6% faster than 256, K2's shape,
// and 1% faster than 64 (scripts/bench_shapes.py K10)
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
