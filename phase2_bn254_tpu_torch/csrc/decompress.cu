// D1: point decompression for BN254 G1 and G2, one thread per point, and
// D1-BLS, the same at BLS12-381 width.
//
// Replaces XLA glue of the JAX package, not a Pallas kernel:
// phase2_bn254_tpu/curve/codecs.py _g1_decompress and _g2_decompress, and
// (D1-BLS) phase2_bn254_tpu/bls12_381/codecs_device.py _g1_decompress (:87)
// and _g2_decompress (:132). In: the compressed x coordinate as canonical
// int64 16-bit digits ((N, 16) for G1, (N, 2, 16) = [c0, c1] for G2; BLS:
// (N, 24), (N, 2, 24)) and the "greatest" flag of each point (bool). Out: x,
// y Montgomery affine (fully reduced; BLS R = 2^384) and a valid flag per
// point.
//   G1: y = (x^3 + b)^((q+1)/4), valid iff y^2 == x^3 + b (b = 3; BLS 4).
//   G2: the Fq2 square root of the reference's Algorithm 9 (eprint 2012/685,
//       fq2.rs:211-258; both q = 3 mod 4): a1 = v^((q-3)/4), alpha = a1^2 v,
//       a0 = conj(alpha) alpha; v is a non-residue iff a0 == -1; y = a1 v u
//       if alpha == -1, else a1 v (1 + alpha)^((q-1)/2); valid iff y^2 == v
//       and v is a residue (v = x^3 + b', b' = 3 / (9 + u); BLS 4 (1 + u)).
// Then y or -y: the one whose canonical value is the greater (Fq2 order:
// c1 first, then c0) when the flag is set, the other when it is not. One
// template per group over a constants set (Bn254D1, Bls12381D1) writes both
// widths; the BN254 names and signatures stay.
//
// What bounds it on this card: 32-bit integer multiply throughput. A G1
// point costs about 385 Montgomery products (one 254-bit exponentiation), a
// G2 point about 1,800 (two exponentiations in Fq2); at BLS width about 610
// products and squares of 12 limbs a G1 point (a 379-bit exponent: 0.31 M
// 32-bit multiplies at 588 / 456 a product / square, 2.2x BN254's) and two
// 379-bit exponentiations in Fq2 a G2 point (1.57 M multiplies). Every
// thread runs the same exponent bits, so the warps do not diverge except at
// the rare alpha == -1 branch.
// Inputs and outputs are a few hundred bytes per point, far below the
// multiply bound. The design keeps one point per thread with all state in
// registers.
//
// Outside nvcc (no __CUDACC__) only the per-point functions are compiled, so
// a host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// D1's field and constants of one curve: the base field F, its quadratic
// extension F2 (u^2 = -1 on both curves), the exponents' 32-bit words, and
// the values in Montgomery form but R^2, an integer.
struct Bn254D1 {
  using F = Fp;
  using F2 = Fp2;
  static constexpr int kExpWords = 8;
  __device__ static __forceinline__ Fp zero() { return fp_zero(); }
  __device__ static __forceinline__ Fp one() { return fp_one(); }
  __device__ static __forceinline__ Fp r2() { return fp_from_const(FQ_R2); }
  __device__ static __forceinline__ Fp b_g1() { return fp_from_const(B_G1); }
  __device__ static __forceinline__ Fp2 b_g2() { return fp2_from_const(B_G2_C0, B_G2_C1); }
  __device__ static __forceinline__ Fp neg_one() { return fp_from_const(FQ_NEG_ONE); }
  __device__ static __forceinline__ const uint32_t* exp_sqrt_g1() { return EXP_SQRT_G1; }
  __device__ static __forceinline__ const uint32_t* exp_g2_a1() { return EXP_G2_A1; }
  __device__ static __forceinline__ const uint32_t* exp_g2_b() { return EXP_G2_B; }
};

struct Bls12381D1 {
  using F = BFp;
  using F2 = BFp2;
  static constexpr int kExpWords = 12;
  __device__ static __forceinline__ BFp zero() { return bfp_zero(); }
  __device__ static __forceinline__ BFp one() { return bfp_one(); }
  __device__ static __forceinline__ BFp r2() { return bfp_from_const(BLS_FQ_R2); }
  __device__ static __forceinline__ BFp b_g1() { return bfp_from_const(BLS_B_G1); }
  __device__ static __forceinline__ BFp2 b_g2() { return bfp2_from_const(BLS_B_G2_C0, BLS_B_G2_C1); }
  __device__ static __forceinline__ BFp neg_one() { return bfp_from_const(BLS_FQ_NEG_ONE); }
  __device__ static __forceinline__ const uint32_t* exp_sqrt_g1() { return BLS_EXP_SQRT_G1; }
  __device__ static __forceinline__ const uint32_t* exp_g2_a1() { return BLS_EXP_G2_A1; }
  __device__ static __forceinline__ const uint32_t* exp_g2_b() { return BLS_EXP_G2_B; }
};

template <class C>
__device__ __forceinline__ typename C::F to_mont(const typename C::F& a) {
  return mul(a, C::r2());
}

template <class C>
__device__ __forceinline__ typename C::F from_mont(const typename C::F& a) {
  typename C::F one = C::zero();  // the integer 1
  one.v[0] = 1;
  return mul(a, one);
}

// Point i of a G1 batch of curve C.
template <class C>
__device__ void decompress_g1(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                              int64_t i) {
  using F = typename C::F;
  constexpr int D = kDigits<F>;
  F x;
  load_el(xd + D * i, x);
  x = to_mont<C>(x);
  F rhs = add(mul(sqr(x), x), C::b_g1());
  F y = pow_public<F, C::kExpWords>(rhs, C::exp_sqrt_g1(), C::one());
  F ny = neg(y);
  bool y_greatest = gt(from_mont<C>(y), from_mont<C>(ny));
  store_el(ox + D * i, x);
  store_el(oy + D * i, y_greatest == greatest[i] ? y : ny);
  valid[i] = eq(sqr(y), rhs);
}

// Point i of a G2 batch of curve C.
template <class C>
__device__ void decompress_g2(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                              int64_t i) {
  using F = typename C::F;
  using F2 = typename C::F2;
  constexpr int D = kDigits<F2>;
  F2 x;
  load_el(xd + D * i, x);
  x = {to_mont<C>(x.c0), to_mont<C>(x.c1)};
  F2 v = add(mul(sqr(x), x), C::b_g2());
  const F2 one = {C::one(), C::zero()};
  F2 a1 = pow_public<F2, C::kExpWords>(v, C::exp_g2_a1(), one);
  F2 alpha = mul(sqr(a1), v);
  F2 a0 = mul(conj(alpha), alpha);
  F2 neg1 = {C::neg_one(), C::zero()};
  bool nonresidue = eq(a0, neg1);
  F2 a1v = mul(a1, v);
  F2 y;
  if (eq(alpha, neg1)) {
    y = mul(a1v, F2{C::zero(), C::one()});  // times u
  } else {
    y = mul(a1v, pow_public<F2, C::kExpWords>(add(alpha, one), C::exp_g2_b(), one));
  }
  F2 ny = neg(y);
  F2 yc = {from_mont<C>(y.c0), from_mont<C>(y.c1)};
  F2 nyc = {from_mont<C>(ny.c0), from_mont<C>(ny.c1)};
  bool y_greatest = gt(yc.c1, nyc.c1) || (eq(yc.c1, nyc.c1) && gt(yc.c0, nyc.c0));
  store_el(ox + D * i, x);
  store_el(oy + D * i, y_greatest == greatest[i] ? y : ny);
  valid[i] = eq(sqr(y), v) && !nonresidue;
}

// Point i of a BN254 batch.
__device__ void decompress_g1_point(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                                    int64_t i) {
  decompress_g1<Bn254D1>(xd, greatest, ox, oy, valid, i);
}

__device__ void decompress_g2_point(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                                    int64_t i) {
  decompress_g2<Bn254D1>(xd, greatest, ox, oy, valid, i);
}

// Point i of a BLS12-381 batch.
__device__ void decompress_bls_g1_point(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy,
                                        bool* valid, int64_t i) {
  decompress_g1<Bls12381D1>(xd, greatest, ox, oy, valid, i);
}

__device__ void decompress_bls_g2_point(const int64_t* xd, const bool* greatest, int64_t* ox, int64_t* oy,
                                        bool* valid, int64_t i) {
  decompress_g2<Bls12381D1>(xd, greatest, ox, oy, valid, i);
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

__global__ void __launch_bounds__(kThreads)
decompress_bls_g1_kernel(const int64_t* __restrict__ xd, const bool* __restrict__ greatest,
                         int64_t* __restrict__ ox, int64_t* __restrict__ oy, bool* __restrict__ valid, int n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) decompress_bls_g1_point(xd, greatest, ox, oy, valid, i);
}

__global__ void __launch_bounds__(kThreads)
decompress_bls_g2_kernel(const int64_t* __restrict__ xd, const bool* __restrict__ greatest,
                         int64_t* __restrict__ ox, int64_t* __restrict__ oy, bool* __restrict__ valid, int n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) decompress_bls_g2_point(xd, greatest, ox, oy, valid, i);
}

using DecompressKernel = void (*)(const int64_t*, const bool*, int64_t*, int64_t*, bool*, int);

int launch(DecompressKernel kernel, const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
           void* stream) {
  if (n > 0) {
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)xd, (const bool*)greatest, (int64_t*)ox, (int64_t*)oy, (bool*)valid, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches D1 (D1-BLS) on `stream` and returns cudaGetLastError() after
// the launch.
extern "C" int p2_decompress_g1(const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
                                void* stream) {
  return launch(decompress_g1_kernel, xd, greatest, ox, oy, valid, n, stream);
}

extern "C" int p2_decompress_g2(const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
                                void* stream) {
  return launch(decompress_g2_kernel, xd, greatest, ox, oy, valid, n, stream);
}

extern "C" int p2_decompress_bls_g1(const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
                                    void* stream) {
  return launch(decompress_bls_g1_kernel, xd, greatest, ox, oy, valid, n, stream);
}

extern "C" int p2_decompress_bls_g2(const void* xd, const void* greatest, void* ox, void* oy, void* valid, int n,
                                    void* stream) {
  return launch(decompress_bls_g2_kernel, xd, greatest, ox, oy, valid, n, stream);
}
#endif  // __CUDACC__
