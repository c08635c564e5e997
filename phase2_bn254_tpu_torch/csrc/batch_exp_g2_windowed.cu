// K9: plain windowed ladder for BN254 G2, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_g2 (_batch_exp_kernel_g2): out[i] = k_i * Q_i for
// canonical scalars k_i, without an endomorphism split. The table holds
// T[j] = j Q for j = 0..15 (T[0] = infinity, T[2] = Q + Q through the
// doubling branch); then for each of the 64 4-bit windows of k, most
// significant first, 4 doublings and one add of T[d]. The windows are cut
// here from the scalar's 16-bit digits (the TPU kernel reads a 64 x N digit
// array); they are the digits of ops/batch_exp.scalar_windows_msb. The
// per-point ladder is ladders.cuh's windowed_ladder_point, which K8 runs
// over Fq.
// In: x, y int64 (N, 2, 16) Montgomery affine ([c0, c1]), finite points;
// k int64 (N, 16) canonical 16-bit digits. Out: x, y, z int64 (N, 2, 16),
// Jacobian, Montgomery, fully reduced (k = 0 gives z = 0).
//
// What bounds it on the card: 32-bit integer multiply throughput, about
// 7,400 Fq products a point (256 doublings of 16, up to 63 adds of 43, the
// table), some 1.7 times K2's, which splits k in four with psi. The
// per-thread table of 16 Fq2 Jacobian points (3 KB) lives in local memory
// and is read once per window. The design is K2's: one point per thread, no
// cross-thread carries, the table in local memory; the phase-2 QAP
// evaluation calls it once per `new` on the b_g2 terms.
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ladders.cuh"

// Point i of the batch.
__device__ void batch_exp_g2_windowed_point(const int64_t* x, const int64_t* y, const int64_t* k,
                                            int64_t* ox, int64_t* oy, int64_t* oz, int i) {
  windowed_ladder_point<Fp2>(x, y, k, ox, oy, oz, i);
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
batch_exp_g2_windowed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                             const int64_t* __restrict__ k, int64_t* __restrict__ ox,
                             int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_g2_windowed_point(x, y, k, ox, oy, oz, i);
}

}  // namespace

// Launches K9 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_g2_windowed(const void* x, const void* y, const void* k, void* ox, void* oy,
                                        void* oz, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_g2_windowed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)k, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
