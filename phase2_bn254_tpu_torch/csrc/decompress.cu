// D1: point decompression for BN254 G1 and G2, one thread per point.
//
// Replaces XLA glue of the JAX package, not a Pallas kernel:
// phase2_bn254_tpu/curve/codecs.py _g1_decompress and _g2_decompress. In: the
// compressed x coordinate as canonical int64 16-bit digits ((N, 16) for G1,
// (N, 2, 16) = [c0, c1] for G2) and the "greatest" flag of each point (bool).
// Out: x, y Montgomery affine (fully reduced) and a valid flag per point.
//   G1: y = (x^3 + 3)^((q+1)/4), valid iff y^2 == x^3 + 3.
//   G2: the Fq2 square root of the reference's Algorithm 9 (eprint 2012/685,
//       fq2.rs:211-258): a1 = v^((q-3)/4), alpha = a1^2 v, a0 = conj(alpha)
//       alpha; v is a non-residue iff a0 == -1; y = a1 v u if alpha == -1,
//       else a1 v (1 + alpha)^((q-1)/2); valid iff y^2 == v and v is a
//       residue.
// Then y or -y: the one whose canonical value is the greater (Fq2 order:
// c1 first, then c0) when the flag is set, the other when it is not.
//
// What bounds it on this card: 32-bit integer multiply throughput. A G1
// point costs about 385 Montgomery products (one 254-bit exponentiation), a
// G2 point about 1,800 (two exponentiations in Fq2); every thread runs the
// same exponent bits, so the warps do not diverge except at the rare
// alpha == -1 branch. Inputs and outputs are a few hundred bytes per point,
// far below the multiply bound. The design keeps one point per thread with
// all state in registers.
//
// Outside nvcc (no __CUDACC__) only the per-point functions are compiled, so
// a host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

__device__ __forceinline__ Fp fp_int(uint32_t v) {
  Fp r = fp_zero();
  r.v[0] = v;
  return r;
}

__device__ __forceinline__ Fp to_mont(const Fp& a) { return mul(a, fp_from_const(FQ_R2)); }
__device__ __forceinline__ Fp from_mont(const Fp& a) { return mul(a, fp_int(1)); }

// Point i of the batch.
__device__ void decompress_g1_point(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                                    int64_t i) {
  Fp x = to_mont(load_fp(xd + 16 * i));
  Fp rhs = add(mul(sqr(x), x), fp_from_const(B_G1));
  Fp y = pow_public(rhs, EXP_SQRT_G1, fp_one());
  Fp ny = neg(y);
  bool y_greatest = gt(from_mont(y), from_mont(ny));
  store_fp(ox + 16 * i, x);
  store_fp(oy + 16 * i, y_greatest == greatest[i] ? y : ny);
  valid[i] = eq(sqr(y), rhs);
}

__device__ void decompress_g2_point(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                                    int64_t i) {
  Fp2 x = {to_mont(load_fp(xd + 32 * i)), to_mont(load_fp(xd + 32 * i + 16))};
  Fp2 v = add(mul(sqr(x), x), fp2_from_const(B_G2_C0, B_G2_C1));
  Fp2 a1 = pow_public(v, EXP_G2_A1, fp2_one());
  Fp2 alpha = mul(sqr(a1), v);
  Fp2 a0 = mul(conj(alpha), alpha);
  Fp2 neg1 = {fp_from_const(FQ_NEG_ONE), fp_zero()};
  bool nonresidue = eq(a0, neg1);
  Fp2 a1v = mul(a1, v);
  Fp2 y;
  if (eq(alpha, neg1)) {
    y = mul(a1v, Fp2{fp_zero(), fp_one()});  // times u
  } else {
    y = mul(a1v, pow_public(add(alpha, fp2_one()), EXP_G2_B, fp2_one()));
  }
  Fp2 ny = neg(y);
  Fp2 yc = {from_mont(y.c0), from_mont(y.c1)};
  Fp2 nyc = {from_mont(ny.c0), from_mont(ny.c1)};
  bool y_greatest = gt(yc.c1, nyc.c1) || (eq(yc.c1, nyc.c1) && gt(yc.c0, nyc.c0));
  store_el(ox + 32 * i, x);
  store_el(oy + 32 * i, y_greatest == greatest[i] ? y : ny);
  valid[i] = eq(sqr(y), v) && !nonresidue;
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
decompress_g1_kernel(const int64_t* __restrict__ xd, const bool* __restrict__ greatest, int64_t* __restrict__ ox,
                     int64_t* __restrict__ oy, bool* __restrict__ valid, int n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) decompress_g1_point(xd, greatest, ox, oy, valid, i);
}

__global__ void __launch_bounds__(kThreads)
decompress_g2_kernel(const int64_t* __restrict__ xd, const bool* __restrict__ greatest, int64_t* __restrict__ ox,
                     int64_t* __restrict__ oy, bool* __restrict__ valid, int n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) decompress_g2_point(xd, greatest, ox, oy, valid, i);
}

}  // namespace

// Each launches D1 on `stream` and returns cudaGetLastError() after the launch.
extern "C" int p2_decompress_g1(const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
                                void* stream) {
  if (n > 0) {
    decompress_g1_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)xd, (const bool*)greatest, (int64_t*)ox, (int64_t*)oy, (bool*)valid, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int p2_decompress_g2(const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
                                void* stream) {
  if (n > 0) {
    decompress_g2_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)xd, (const bool*)greatest, (int64_t*)ox, (int64_t*)oy, (bool*)valid, n);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
