// K9: plain windowed ladder for BN254 G2, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp_g2 (_batch_exp_kernel_g2): out[i] = k_i * Q_i for
// canonical scalars k_i, without an endomorphism split, by 4-bit windows of
// k, most significant first (the TPU kernel reads a 64 x N digit array; here
// each thread cuts the windows from its scalar's 16-bit digits). The
// per-point ladder is ladders.cuh's windowed_ladder_point, which K8 runs
// over Fq; it does only the work the scalar needs: k > (r - 1)/2 is taken
// as (r - k)(-Q), the ladder starts at the first nonzero window, and the
// table j Q is built, by mixed adds, only where a digit above 1 occurs. The
// same template over BLS12-381's Fq2 is K9-BLS (the JAX package's
// bls12_381/device.py:147 pallas_batch_mul runs pallas_batch_exp_g2 with its
// 24-limb field constants).
// In: x, y int64 (N, 2, 16) Montgomery affine ([c0, c1]), finite points;
// k int64 (N, 16) canonical 16-bit digits. Out: x, y, z int64 (N, 2, 16),
// Jacobian, Montgomery, fully reduced (k = 0 gives (0, 1, 0)). K9-BLS: x, y,
// out int64 (N, 2, 24), R = 2^384; k canonical mod BLS r (N, 16).
//
// What bounds it on the card: 32-bit integer multiply throughput, for
// uniform scalars about 4 doublings and 1 add a window over ~63 windows (an
// Fq2 product 656 multiplies, a square 528: ops/batch_exp.py's plain version
// does the same adds), some 1.7 times K2, which splits k in four with psi.
// The phase-2 QAP evaluation calls it once per `new` on the b_g2 terms,
// whose coefficients are the circuit's B entries: 1, r - 1 and small powers
// of two, which take one window and no table. The per-thread table (at most
// 16 Fq2 Jacobian points, 3 KB) lives in local memory. K9-BLS: an Fq2
// product 1,464 multiplies, a square 1,176 (2.2x), a Jacobian point 288
// bytes and its table 4.6 KB a thread, in local memory.
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

// Point i of a BLS12-381 batch.
__device__ void batch_exp_bls_g2_windowed_point(const int64_t* x, const int64_t* y, const int64_t* k,
                                                int64_t* ox, int64_t* oy, int64_t* oz, int i) {
  windowed_ladder_point<BFp2, Bls12381Scalars>(x, y, k, ox, oy, oz, i);
}

#ifdef __CUDACC__
namespace {

// 128 threads a block: on an H100 3.6% faster than 256 (9% on `new`'s
// terms) and within 1% of 64 (scripts/bench_shapes.py K9; 255 registers
// allow 256 threads an SM in every shape)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
batch_exp_g2_windowed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                             const int64_t* __restrict__ k, int64_t* __restrict__ ox,
                             int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_g2_windowed_point(x, y, k, ox, oy, oz, i);
}

// K9-BLS: 128 threads a block: 255 registers and spills (596 bytes of
// stores) in every shape; on an NVIDIA H100 80GB HBM3 at 700 W 0.5% faster
// than 64 or 256 threads (scripts/bench_shapes.py K9-BLS)
constexpr int kBlsThreads = 128;

__global__ void __launch_bounds__(kBlsThreads)
batch_exp_bls_g2_windowed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                 const int64_t* __restrict__ k, int64_t* __restrict__ ox,
                                 int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_bls_g2_windowed_point(x, y, k, ox, oy, oz, i);
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

// Launches K9-BLS on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_bls_g2_windowed(const void* x, const void* y, const void* k, void* ox, void* oy,
                                            void* oz, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kBlsThreads - 1) / kBlsThreads;
    batch_exp_bls_g2_windowed_kernel<<<blocks, kBlsThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)k, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
