// Per-point pieces shared by the batch scalar multiplication kernels
// (batch_exp_*.cu): the plain windowed ladder of K8 (G1) and K9 (G2), at
// BN254 and at BLS12-381 width (K8-BLS, K9-BLS), and the GLS endomorphism
// powers psi^c of K2 and K10.
#pragma once

#include <type_traits>

#include "field.cuh"

// The scalar field of a curve as the windowed ladder's recoding reads it:
// limb l of r and of (r - 1)/2, 8 limbs each (r < 2^255 on both curves)
struct Bn254Scalars {
  __device__ static __forceinline__ uint32_t p(int l) { return FR_P[l]; }
  __device__ static __forceinline__ uint32_t half(int l) { return FR_HALF[l]; }
};

struct Bls12381Scalars {
  __device__ static __forceinline__ uint32_t p(int l) { return BLS_FR_P[l]; }
  __device__ static __forceinline__ uint32_t half(int l) { return BLS_FR_HALF[l]; }
};

// out[i] = k_i * P_i for canonical scalars k (N, 16) of the scalar field S,
// each thread doing only the work its scalar needs:
// * a scalar above (r - 1)/2 is taken as (r - k)(-P): one 256-bit
//   subtraction and -y, so every ladder runs on at most 253 bits (254 on
//   BLS12-381) and a
//   circuit's coefficients r - 1 and r - 2^j cost what 1 and 2^j do;
// * the ladder starts at the first nonzero 4-bit window (most significant
//   first) with acc = T[d], no doublings before it; after it each window
//   does 4 doublings and, for a nonzero digit d, one add of T[d];
// * T[2..15] (T[j] = j P) is built only where a digit above 1 occurs, so a
//   scalar whose digits are 0 and 1 (1, r - 1, 2^j) builds nothing. Over
//   Fq2 by a doubling and mixed adds of the affine P; over Fq by general
//   adds, which on an H100 run the G1 ladder 2% faster (the mixed-add form
//   and a table built only up to the largest digit were slower there:
//   scripts/bench_shapes.py K8). Both give the limbs of general adds, as
//   every value is fully reduced.
// The scalar and the table live in local memory, T[1] loaded in place. The
// limbs are those of the full 64-window ladder over the recoded scalar (an
// add into infinity returns its other operand, and an add of T[0] returns
// acc); a zero scalar gives (0, 1, 0), as that ladder does. The windows are
// cut from the scalar's 16-bit digits (ops/batch_exp.scalar_windows_msb).
// x, y: (N, kDigits<F>) Montgomery affine, finite; out: Jacobian, fully
// reduced. Any field type with load_el / store_el, neg and jac_infinity
// (Fp, Fp2 with S = Bn254Scalars; BFp, BFp2 with Bls12381Scalars).
template <class F, class S = Bn254Scalars>
__device__ void windowed_ladder_point(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t i) {
  Fr s = load_limbs<Fr>(k + 16 * i);
  Jac<F> table[16];
  load_el(x + kDigits<F> * i, table[1].x);
  load_el(y + kDigits<F> * i, table[1].y);
  table[1].z = jac_infinity<F>().y;  // one
  int64_t borrow = 0;  // (r - 1)/2 - k < 0: k above (r - 1)/2
#pragma unroll
  for (int l = 0; l < 8; ++l) borrow = ((int64_t)S::half(l) - (int64_t)s.v[l] + borrow) >> 32;
  if (borrow < 0) {
    int64_t b = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int64_t t = (int64_t)S::p(l) - (int64_t)s.v[l] + b;
      s.v[l] = (uint32_t)t;
      b = t >> 32;
    }
    table[1].y = neg(table[1].y);
  }
  int first = 0, top = 0;  // the first nonzero window (0 if none is), the largest digit
  for (int w = 0; w < 64; ++w) {  // window w holds bits 4w .. 4w + 3
    const int d = (int)((s.v[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (d != 0) first = w;
    top = d > top ? d : top;
  }
  if (top >= 2) {
    if constexpr (std::is_same_v<F, Fp> || std::is_same_v<F, BFp>) {
      for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], table[1]);  // j = 2 doubles
    } else {
      table[2] = jac_double(table[1]);
      for (int j = 3; j < 16; ++j) table[j] = jac_madd(table[j - 1], table[1].x, table[1].y);
    }
  }

  const int d0 = (int)((s.v[first >> 3] >> (4 * (first & 7))) & 0xF);
  Jac<F> acc = d0 == 0 ? jac_infinity<F>() : table[d0];
  for (int w = first - 1; w >= 0; --w) {
    for (int t = 0; t < 4; ++t) acc = jac_double(acc);
    const int d = (int)((s.v[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (d != 0) acc = jac_add(acc, table[d]);
  }
  store_jac(ox, oy, oz, i, acc);
}

// psi^c of a Jacobian G2 point, c = 0..3:
//   psi^1(x, y, z) = (conj(x) C1,  conj(y) C2,  conj(z))
//   psi^2(x, y, z) = (x N1,        y N2,        z)        N1, N2 in Fq
//   psi^3(x, y, z) = (conj(x) C31, conj(y) C32, conj(z))
__device__ __forceinline__ Jac<Fp2> psi_pow(int c, const Jac<Fp2>& e) {
  if (c == 1)
    return {mul(conj(e.x), fp2_from_const(GLS_C1_C0, GLS_C1_C1)),
            mul(conj(e.y), fp2_from_const(GLS_C2_C0, GLS_C2_C1)), conj(e.z)};
  if (c == 2) return {mul_fp(e.x, fp_from_const(GLS_N1)), mul_fp(e.y, fp_from_const(GLS_N2)), e.z};
  if (c == 3)
    return {mul(conj(e.x), fp2_from_const(GLS_C31_C0, GLS_C31_C1)),
            mul(conj(e.y), fp2_from_const(GLS_C32_C0, GLS_C32_C1)), conj(e.z)};
  return e;
}
