// Per-point pieces shared by the batch scalar multiplication kernels
// (batch_exp_*.cu): the plain windowed ladder of K8 (G1) and K9 (G2), and
// the GLS endomorphism powers psi^c of K2 and K10.
#pragma once

#include "field.cuh"

// out[i] = k_i * P_i for canonical scalars k (N, 16): T[j] = j P for
// j = 0..15 (T[0] = infinity, T[2] = P + P through the doubling branch),
// then for each of the 64 4-bit windows of k, most significant first, 4
// doublings and one add of T[d]. The windows are cut from the scalar's
// 16-bit digits (ops/batch_exp.scalar_windows_msb). x, y: (N, kDigits<F>)
// Montgomery affine, finite; out: Jacobian, fully reduced (k = 0 gives
// z = 0). Any field type with load_el / store_el and jac_infinity.
template <class F>
__device__ void windowed_ladder_point(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t i) {
  Jac<F> table[16];
  table[0] = jac_infinity<F>();
  load_el(x + kDigits<F> * i, table[1].x);
  load_el(y + kDigits<F> * i, table[1].y);
  table[1].z = table[0].y;  // one
  for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], table[1]);  // j = 2 is P + P

  const int64_t* s = k + 16 * i;
  Jac<F> acc = jac_infinity<F>();
  for (int w = 63; w >= 0; --w) {  // window w holds bits 4w .. 4w + 3
    for (int t = 0; t < 4; ++t) acc = jac_double(acc);
    int d = (int)((s[w >> 2] >> (4 * (w & 3))) & 0xF);
    acc = jac_add(acc, table[d]);
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
