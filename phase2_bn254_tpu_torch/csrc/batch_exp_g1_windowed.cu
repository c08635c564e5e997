// K8: plain windowed ladder for BN254 G1, one thread per point.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_exp.py
// pallas_batch_exp (_batch_exp_kernel): out[i] = k_i * P_i for canonical
// scalars k_i, without an endomorphism split, by 4-bit windows of k, most
// significant first. The per-point ladder is ladders.cuh's
// windowed_ladder_point, the one K9 runs over Fq2 (k > (r - 1)/2 as (r -
// k)(-P), a start at the first nonzero window, the table only where a
// digit above 1 occurs, here by general adds); it is a template over the
// field type, as the TPU kernel is generic in its limb count, and is
// instantiated here for BN254 Fq and for BLS12-381 Fq (K8-BLS: the JAX
// package's bls12_381/device.py:147 pallas_batch_mul runs the same TPU kernel
// with its 24-limb field constants). The windows are cut from the scalar's
// 16-bit digits (the TPU kernel reads a 64 x N digit array).
// In: x, y int64 (N, 16) Montgomery affine, finite points; k int64 (N, 16)
// canonical 16-bit digits. Out: x, y, z int64 (N, 16), Jacobian, Montgomery,
// fully reduced (k = 0 gives (0, 1, 0)). The ceremony runs it for G1 under
// PHASE2_TPU_NO_GLV (ops/backend.py Ladders). K8-BLS: x, y, out int64 (N,
// 24), R = 2^384; k canonical mod BLS r (N, 16); the BLS12-381 device path
// (bls12_381/device.py) runs it.
//
// What bounds it on the card: 32-bit integer multiply throughput, about
// 2,900 Fq products a point for uniform scalars (252 doublings of 7, up to
// 63 adds of 16, the table), some 1.5 times K1's, which halves the ladder
// with the GLV split and widens its windows. The per-thread table of up to
// 16 Jacobian points (1.5 KB) lives in local memory. The design is K1's and
// K9's: one point per thread, no cross-thread carries. K8-BLS does the same
// work on 12 x 32-bit limbs: 588 multiplies an Fq product, 456 a square
// (2.2x BN254's), and a table of up to 16 points of 144 bytes (2.3 KB).
//
// Outside nvcc (no __CUDACC__) only the per-point function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ladders.cuh"

// Point i of the batch.
__device__ void batch_exp_g1_windowed_point(const int64_t* x, const int64_t* y, const int64_t* k,
                                            int64_t* ox, int64_t* oy, int64_t* oz, int i) {
  windowed_ladder_point<Fp>(x, y, k, ox, oy, oz, i);
}

// Point i of a BLS12-381 batch.
__device__ void batch_exp_bls_g1_windowed_point(const int64_t* x, const int64_t* y, const int64_t* k,
                                                int64_t* ox, int64_t* oy, int64_t* oz, int i) {
  windowed_ladder_point<BFp, Bls12381Scalars>(x, y, k, ox, oy, oz, i);
}

#ifdef __CUDACC__
namespace {

// 128 threads a block, launch bounds asking 4 blocks an SM (at most 128
// registers, 16 warps an SM): on an H100 3.3% faster than without them (146
// registers), than asking 3 and than 64 threads, 4.5% faster than 256
// (scripts/bench_shapes.py K8)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads, 4)
batch_exp_g1_windowed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                             const int64_t* __restrict__ k, int64_t* __restrict__ ox,
                             int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_g1_windowed_point(x, y, k, ox, oy, oz, i);
}

// K8-BLS: 128 threads a block, no launch bounds: 222 registers, no spill; on
// an NVIDIA H100 80GB HBM3 at 700 W within 0.1% of 64 threads and of bounds
// asking 2 blocks an SM, 5% faster than 256 threads, 26% faster than bounds
// asking 3 (168 registers, spills) (scripts/bench_shapes.py K8-BLS)
constexpr int kBlsThreads = 128;

__global__ void __launch_bounds__(kBlsThreads)
batch_exp_bls_g1_windowed_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                 const int64_t* __restrict__ k, int64_t* __restrict__ ox,
                                 int64_t* __restrict__ oy, int64_t* __restrict__ oz, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_exp_bls_g1_windowed_point(x, y, k, ox, oy, oz, i);
}

}  // namespace

// Launches K8 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_g1_windowed(const void* x, const void* y, const void* k, void* ox, void* oy,
                                        void* oz, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    batch_exp_g1_windowed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)k, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}

// Launches K8-BLS on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_batch_exp_bls_g1_windowed(const void* x, const void* y, const void* k, void* ox, void* oy,
                                            void* oz, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kBlsThreads - 1) / kBlsThreads;
    batch_exp_bls_g1_windowed_kernel<<<blocks, kBlsThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)k, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
