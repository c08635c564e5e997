// K1: signed GLV double ladder for BN254 G1, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_glv_signed (_batch_exp_glv_signed_kernel): out[i] =
// k_i * P_i with k_i = k1 + k2 * lambda split by ops/glv.py into signed
// base-32 digits d1, d2 in [-16, 16], most significant window first. Each
// window does 5 doublings, then adds sign(d1) T[|d1|] and sign(d2)
// phi(T[|d2|]), where T[j] = j P (T[0] = infinity) and phi(x, y) = (beta x, y).
// In: x, y int64 (N, 16) Montgomery affine; d1, d2 int64 (W, N). Out:
// x, y, z int64 (N, 16), Jacobian, Montgomery, fully reduced.
//
// What bounds it on the card: 32-bit integer multiply throughput (about
// 2000 Montgomery products per point, 128 wide multiplies each) and the
// per-thread table of 17 Jacobian points plus 17 beta x planes (2.2 KB),
// which lives in local memory and is read twice per window. The design keeps
// one point per thread (no cross-thread carries), fully unrolled 32-bit CIOS
// for the multiply, and accepts the table in local memory; the doubling
// branch for P + P (hit at table step 2) and the cancellation case are
// per-thread branches rather than masks.
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// Point i of the batch (W = nw windows).
__device__ void batch_exp_glv_signed_point(const int64_t* x, const int64_t* y, const int64_t* d1,
                                           const int64_t* d2, int64_t* ox, int64_t* oy, int64_t* oz,
                                           int i, int n, int nw) {
  const Fp beta = fp_from_const(GLV_BETA);

  Jac<Fp> table[17];
  Fp beta_x[17];
  table[0] = jac_infinity<Fp>();
  beta_x[0] = fp_zero();
  table[1] = {load_fp(x + 16 * (int64_t)i), load_fp(y + 16 * (int64_t)i), fp_one()};
  beta_x[1] = mul(table[1].x, beta);
  for (int k = 2; k < 17; ++k) {
    table[k] = jac_add(table[k - 1], table[1]);  // k = 2 is P + P
    beta_x[k] = mul(table[k].x, beta);
  }

  Jac<Fp> acc = jac_infinity<Fp>();
  for (int w = 0; w < nw; ++w) {
    for (int s = 0; s < 5; ++s) acc = jac_double(acc);
    int da = (int)d1[(int64_t)w * n + i];
    Jac<Fp> e = table[da < 0 ? -da : da];
    if (da < 0) e.y = neg(e.y);
    acc = jac_add(acc, e);
    int db = (int)d2[(int64_t)w * n + i];
    int ab = db < 0 ? -db : db;
    e = {beta_x[ab], table[ab].y, table[ab].z};
    if (db < 0) e.y = neg(e.y);
    acc = jac_add(acc, e);
  }
  store_fp(ox + 16 * (int64_t)i, acc.x);
  store_fp(oy + 16 * (int64_t)i, acc.y);
  store_fp(oz + 16 * (int64_t)i, acc.z);
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
#endif  // __CUDACC__
