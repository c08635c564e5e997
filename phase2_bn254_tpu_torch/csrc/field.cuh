// BN254 Fq, Fq2 and Fr arithmetic and the Jacobian group law, one thread per
// point or per lane, for the kernels of this directory (batch_exp_g1.cu,
// batch_exp_g2.cu, batch_exp_g2_windowed.cu, batch_exp_g1_windowed.cu,
// batch_exp_glv.cu, batch_exp_gls.cu, msm.cu, decompress.cu,
// segsum.cu, fieldops.cu; Fr for ntt.cu); and BLS12-381's Fq and Fq2 (BFp,
// BFp2) for the BLS instantiations of the G1 ladders
// (batch_exp_g1_windowed.cu, batch_exp_glv.cu, batch_exp_g1.cu), the G2
// windowed ladder (batch_exp_g2_windowed.cu), decompression
// (decompress.cu) and fieldops.cu.
//
// An Fq element (Fp) or an Fr element (Fr) is 8 little-endian 32-bit limbs
// in Montgomery form with R = 2^256, the same values as the 16 x 16-bit
// limbs of the JAX package and of field/fp.py; loads and stores convert
// between the two. A BLS12-381 Fq element (BFp) is 12 limbs, R = 2^384 (the
// JAX package's 24 x 16-bit limbs). Every value stays fully reduced in [0,
// p): equality and the zero test are limb compares, and the kernels' outputs
// equal the plain PyTorch versions' limb for limb.
//
// On the card (__CUDA_ARCH__) the product, the square, the sum and the
// difference are the inline PTX carry chains of field_ptx.cuh (written by
// ops/_ptx.py into the build directory at build time): CIOS with mad.lo.cc / madc.hi.cc chains over the even and
// the odd limbs, and a square that computes its 28 cross products once
// (36 limb products where a product takes 64); the Fq2 product and square
// are one routine each, Karatsuba with lazy reduction (two Montgomery
// reductions where three products did three). Off the card (g++ and
// nvcc's host pass) they are the C++ below, 64-bit products and a
// final conditional subtraction: the host tests run that path, and
// fieldops.cu holds the two against each other on the card.
//
// The group law is dbl-2009-l, add-2007-bl and the mixed add madd-2007-bl
// with the same exceptional cases as curve/group.py (P + O, O + Q, P == Q by
// doubling, P == -Q to infinity). The group operations and the Fq and Fq2
// product and square are __noinline__: one copy of each keeps the kernels'
// code small enough for the instruction cache, at the price of a call per
// operation. Inlined into the group operations, the product made K1 40%
// and K2 120% slower on an H100, and K3 no faster (PERF.md, PR 9);
// `mul_inline` is there for a caller that runs few products, as K5's warp
// does.
#pragma once

#include <cstdint>

#include "constants.cuh"
#if defined(__CUDA_ARCH__)
#include "field_ptx.cuh"
#endif

struct Fp {  // Fq, the base field
  uint32_t v[8];
};

struct Fr {  // the scalar field
  uint32_t v[8];
};

struct Fp2 {
  Fp c0, c1;
};

struct BFp {  // BLS12-381 Fq
  uint32_t v[12];
};

struct BFp2 {  // BLS12-381 Fq2 = Fq[u] / (u^2 + 1)
  BFp c0, c1;
};

// 32-bit limbs of a single-limb-array element type (Fp, Fr, BFp)
template <class E>
constexpr int kLimbs = (int)(sizeof(E) / 4);

template <class F>
struct Jac {
  F x, y, z;
};

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fp fp_from_const(const uint32_t* c) {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ Fp fp_one() { return fp_from_const(FQ_ONE); }

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// The host arithmetic below is written once over the modulus p (N =
// kLimbs<E> limbs) and its -p^-1 mod 2^32, for every modulus (two spare bits
// at least: BN254's 254 bits in 256, BLS12-381's 381 in 384, so a + b < 2^(32
// N) and the CIOS result t < 2p < 2^(32 N)). E is Fp, Fr or BFp.

// r - p if r >= p, else r (r < 2^(32 N))
template <class E>
__device__ __forceinline__ E reduce_once_mod(const E& r, const uint32_t* p) {
  E s;
  int64_t b = 0;
#pragma unroll
  for (int i = 0; i < kLimbs<E>; ++i) {
    int64_t t = (int64_t)r.v[i] - (int64_t)p[i] + b;
    s.v[i] = (uint32_t)t;
    b = t >> 32;  // 0 or -1
  }
  return b < 0 ? r : s;
}

template <class E>
__device__ __forceinline__ E add_mod(const E& a, const E& b, const uint32_t* p) {
  E r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs<E>; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once_mod(r, p);  // a + b < 2p < 2^(32 N): no carry out
}

template <class E>
__device__ __forceinline__ E sub_mod(const E& a, const E& b, const uint32_t* p) {
  E r;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < kLimbs<E>; ++i) {
    int64_t t = (int64_t)a.v[i] - (int64_t)b.v[i] + br;
    r.v[i] = (uint32_t)t;
    br = t >> 32;
  }
  if (br < 0) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < kLimbs<E>; ++i) {
      c += (uint64_t)r.v[i] + p[i];
      r.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return r;
}

// Montgomery product a * b * 2^(-32 N) mod p (CIOS)
template <class E>
__device__ __forceinline__ E mont_mul_mod(const E& a, const E& b, const uint32_t* p, uint32_t pinv) {
  constexpr int N = kLimbs<E>;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * pinv;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  E r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = t[i];
  return reduce_once_mod(r, p);  // t < 2p < 2^(32 N), so t[N] == 0
}

// one definition per field of +, -, x and the square: the PTX chains on the
// card, the C++ above elsewhere
#if defined(__CUDA_ARCH__)
#define P2_FIELD_OPS(E, f, P, PINV)                                                        \
  __device__ __forceinline__ E add(const E& a, const E& b) {                                \
    E r;                                                                                   \
    ptx_add_##f(r.v, a.v, b.v);                                                            \
    return r;                                                                              \
  }                                                                                        \
  __device__ __forceinline__ E sub(const E& a, const E& b) {                                \
    E r;                                                                                   \
    ptx_sub_##f(r.v, a.v, b.v);                                                            \
    return r;                                                                              \
  }                                                                                        \
  __device__ __forceinline__ E mul_inline(const E& a, const E& b) {                         \
    E r;                                                                                   \
    ptx_mul_##f(r.v, a.v, b.v);                                                            \
    return r;                                                                              \
  }                                                                                        \
  __device__ __forceinline__ E sqr_inline(const E& a) {                                     \
    E r;                                                                                   \
    ptx_sqr_##f(r.v, a.v);                                                                 \
    return r;                                                                              \
  }
#else
#define P2_FIELD_OPS(E, f, P, PINV)                                                        \
  __device__ __forceinline__ E add(const E& a, const E& b) { return add_mod(a, b, P); }     \
  __device__ __forceinline__ E sub(const E& a, const E& b) { return sub_mod(a, b, P); }     \
  __device__ __forceinline__ E mul_inline(const E& a, const E& b) {                         \
    return mont_mul_mod(a, b, P, PINV);                                                    \
  }                                                                                        \
  __device__ __forceinline__ E sqr_inline(const E& a) { return mont_mul_mod(a, a, P, PINV); }
#endif

P2_FIELD_OPS(Fp, fq, FQ_P, FQ_PINV)
P2_FIELD_OPS(Fr, fr, FR_P, FR_PINV)
P2_FIELD_OPS(BFp, bls_fq, BLS_FQ_P, BLS_FQ_PINV)

__device__ __forceinline__ Fp neg(const Fp& a) { return sub(fp_zero(), a); }
__device__ __forceinline__ Fp dbl(const Fp& a) { return add(a, a); }
static __device__ __noinline__ Fp mul(Fp a, Fp b) { return mul_inline(a, b); }
static __device__ __noinline__ Fp sqr(Fp a) { return sqr_inline(a); }

// ---------------------------------------------------------------------------
// Fr (always inlined: the NTT's butterflies are its only users)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fr mul(const Fr& a, const Fr& b) { return mul_inline(a, b); }

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fp2 fp2_zero() { return {fp_zero(), fp_zero()}; }
__device__ __forceinline__ Fp2 fp2_one() { return {fp_one(), fp_zero()}; }
__device__ __forceinline__ Fp2 fp2_from_const(const uint32_t* c0, const uint32_t* c1) {
  return {fp_from_const(c0), fp_from_const(c1)};
}

__device__ __forceinline__ bool is_zero(const Fp2& a) { return is_zero(a.c0) && is_zero(a.c1); }
__device__ __forceinline__ bool eq(const Fp2& a, const Fp2& b) { return eq(a.c0, b.c0) && eq(a.c1, b.c1); }
__device__ __forceinline__ Fp2 add(const Fp2& a, const Fp2& b) { return {add(a.c0, b.c0), add(a.c1, b.c1)}; }
__device__ __forceinline__ Fp2 sub(const Fp2& a, const Fp2& b) { return {sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
__device__ __forceinline__ Fp2 neg(const Fp2& a) { return {neg(a.c0), neg(a.c1)}; }
__device__ __forceinline__ Fp2 dbl(const Fp2& a) { return add(a, a); }
__device__ __forceinline__ Fp2 conj(const Fp2& a) { return {a.c0, neg(a.c1)}; }

// The Fq2 product and square, each one call: Karatsuba with lazy reduction.
// The three Fq products a0 b0, a1 b1 and (a0 + a1)(b0 + b1) are 512-bit and
// unreduced (a0 + a1 < 2q < 2^255 needs no reduction either); c0 = a0 b0 -
// a1 b1 + q^2 and c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1 lie in [0, 2 q^2),
// below q 2^256, so one Montgomery reduction and one conditional
// subtraction each give the fully reduced values of fq2.rs:112-204's
// Karatsuba (656 32-bit multiplies where three products take 792). The
// square: c0 = (a0 + a1)(a0 - a1 + q) < 4 q^2 (below q 2^256: q < 2^254),
// c1 = 2 a0 a1, two products and two reductions. On the card these are
// ptx_mul_fq2 / ptx_sqr_fq2 of field_ptx.cuh; off it the C++ below.
#if !defined(__CUDA_ARCH__)
// w = a b, N x N words into 2N
template <int N>
__device__ __forceinline__ void wide_mul(uint32_t* w, const uint32_t* a, const uint32_t* b) {
  for (int i = 0; i < 2 * N; ++i) w[i] = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * b[i] + w[i + j];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
    w[i + N] = (uint32_t)c;
  }
}

// r = a + b and r = a - b on N words; the callers' results fit (no carry or
// borrow out); r may be a or b
template <int N>
__device__ __forceinline__ void wide_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

template <int N>
__device__ __forceinline__ void wide_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  int64_t br = 0;
  for (int i = 0; i < N; ++i) {
    int64_t t = (int64_t)a[i] - (int64_t)b[i] + br;
    r[i] = (uint32_t)t;
    br = t >> 32;
  }
}

// w 2^(-32 N) mod p for a 2N-word w below p 2^(32 N): N rows of m p, then
// the result t[N..2N-1] < 2p through one conditional subtraction
template <class E>
__device__ __forceinline__ E wide_reduce(const uint32_t* w, const uint32_t* p, uint32_t pinv) {
  constexpr int N = kLimbs<E>;
  uint32_t t[2 * N + 1];
  for (int i = 0; i < 2 * N; ++i) t[i] = w[i];
  t[2 * N] = 0;
  for (int i = 0; i < N; ++i) {
    uint32_t m = t[i] * pinv;
    uint64_t c = 0;
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)m * p[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    for (int k = i + N; k < 2 * N + 1; ++k) {
      c += t[k];
      t[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  E r;
  for (int i = 0; i < N; ++i) r.v[i] = t[N + i];
  return reduce_once_mod(r, p);
}

// The fused Fq2 product and square's host path over the base field E
// (Fp or BFp) of modulus p, -p^-1 = pinv, p^2 = p2 (2N words)
template <class E, class E2>
__device__ __forceinline__ E2 fq2_mul_host(const E2& a, const E2& b, const uint32_t* p, uint32_t pinv,
                                           const uint32_t* p2) {
  constexpr int N = kLimbs<E>;
  uint32_t sa[N], sb[N], v0[2 * N], v1[2 * N], c0[2 * N], c1[2 * N];
  wide_add<N>(sa, a.c0.v, a.c1.v);
  wide_add<N>(sb, b.c0.v, b.c1.v);
  wide_mul<N>(v0, a.c0.v, b.c0.v);
  wide_mul<N>(v1, a.c1.v, b.c1.v);
  wide_mul<N>(c1, sa, sb);
  wide_sub<2 * N>(c1, c1, v0);
  wide_sub<2 * N>(c1, c1, v1);
  wide_add<2 * N>(c0, v0, p2);
  wide_sub<2 * N>(c0, c0, v1);
  return {wide_reduce<E>(c0, p, pinv), wide_reduce<E>(c1, p, pinv)};
}

template <class E, class E2>
__device__ __forceinline__ E2 fq2_sqr_host(const E2& a, const uint32_t* p, uint32_t pinv) {
  constexpr int N = kLimbs<E>;
  uint32_t sa[N], da[N], c0[2 * N], c1[2 * N];
  wide_add<N>(sa, a.c0.v, a.c1.v);
  wide_add<N>(da, a.c0.v, p);
  wide_sub<N>(da, da, a.c1.v);
  wide_mul<N>(c0, sa, da);
  wide_mul<N>(c1, a.c0.v, a.c1.v);
  wide_add<2 * N>(c1, c1, c1);
  return {wide_reduce<E>(c0, p, pinv), wide_reduce<E>(c1, p, pinv)};
}
#endif

static __device__ __noinline__ Fp2 mul(Fp2 a, Fp2 b) {
#if defined(__CUDA_ARCH__)
  uint32_t x[16], y[16], r[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = a.c0.v[k], x[8 + k] = a.c1.v[k], y[k] = b.c0.v[k], y[8 + k] = b.c1.v[k];
  ptx_mul_fq2(r, x, y);
  Fp2 o;
#pragma unroll
  for (int k = 0; k < 8; ++k) o.c0.v[k] = r[k], o.c1.v[k] = r[8 + k];
  return o;
#else
  return fq2_mul_host<Fp, Fp2>(a, b, FQ_P, FQ_PINV, FQ_P2);
#endif
}

static __device__ __noinline__ Fp2 sqr(Fp2 a) {
#if defined(__CUDA_ARCH__)
  uint32_t x[16], r[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = a.c0.v[k], x[8 + k] = a.c1.v[k];
  ptx_sqr_fq2(r, x);
  Fp2 o;
#pragma unroll
  for (int k = 0; k < 8; ++k) o.c0.v[k] = r[k], o.c1.v[k] = r[8 + k];
  return o;
#else
  return fq2_sqr_host<Fp, Fp2>(a, FQ_P, FQ_PINV);
#endif
}

__device__ __forceinline__ Fp2 mul_fp(const Fp2& a, const Fp& s) { return {mul(a.c0, s), mul(a.c1, s)}; }

// ---------------------------------------------------------------------------
// BLS12-381 Fq and Fq2 (12 x 32-bit limbs, R = 2^384): the same operations
// and forms as BN254's above. The Fq2 product's lazy reduction has the room
// it needs: c0 = a0 b0 - a1 b1 + q^2 < 2 q^2 and the square's c0 < 4 q^2
// lie below q 2^384, as 4q < 2^384 (q < 2^381). On the card the PTX of
// field_ptx.cuh (ptx_*_bls_fq, ptx_*_bls_fq2), off it the C++ host path.
// ---------------------------------------------------------------------------

__device__ __forceinline__ BFp bfp_zero() {
  BFp r;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ BFp bfp_from_const(const uint32_t* c) {
  BFp r;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ BFp bfp_one() { return bfp_from_const(BLS_FQ_ONE); }

__device__ __forceinline__ bool is_zero(const BFp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const BFp& a, const BFp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

__device__ __forceinline__ BFp neg(const BFp& a) { return sub(bfp_zero(), a); }
__device__ __forceinline__ BFp dbl(const BFp& a) { return add(a, a); }
static __device__ __noinline__ BFp mul(BFp a, BFp b) { return mul_inline(a, b); }
static __device__ __noinline__ BFp sqr(BFp a) { return sqr_inline(a); }

__device__ __forceinline__ BFp2 bfp2_zero() { return {bfp_zero(), bfp_zero()}; }
__device__ __forceinline__ BFp2 bfp2_one() { return {bfp_one(), bfp_zero()}; }
__device__ __forceinline__ BFp2 bfp2_from_const(const uint32_t* c0, const uint32_t* c1) {
  return {bfp_from_const(c0), bfp_from_const(c1)};
}
__device__ __forceinline__ bool is_zero(const BFp2& a) { return is_zero(a.c0) && is_zero(a.c1); }
__device__ __forceinline__ bool eq(const BFp2& a, const BFp2& b) { return eq(a.c0, b.c0) && eq(a.c1, b.c1); }
__device__ __forceinline__ BFp2 add(const BFp2& a, const BFp2& b) { return {add(a.c0, b.c0), add(a.c1, b.c1)}; }
__device__ __forceinline__ BFp2 sub(const BFp2& a, const BFp2& b) { return {sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
__device__ __forceinline__ BFp2 neg(const BFp2& a) { return {neg(a.c0), neg(a.c1)}; }
__device__ __forceinline__ BFp2 dbl(const BFp2& a) { return add(a, a); }
__device__ __forceinline__ BFp2 conj(const BFp2& a) { return {a.c0, neg(a.c1)}; }

static __device__ __noinline__ BFp2 mul(BFp2 a, BFp2 b) {
#if defined(__CUDA_ARCH__)
  uint32_t x[24], y[24], r[24];
#pragma unroll
  for (int k = 0; k < 12; ++k) x[k] = a.c0.v[k], x[12 + k] = a.c1.v[k], y[k] = b.c0.v[k], y[12 + k] = b.c1.v[k];
  ptx_mul_bls_fq2(r, x, y);
  BFp2 o;
#pragma unroll
  for (int k = 0; k < 12; ++k) o.c0.v[k] = r[k], o.c1.v[k] = r[12 + k];
  return o;
#else
  return fq2_mul_host<BFp, BFp2>(a, b, BLS_FQ_P, BLS_FQ_PINV, BLS_FQ_P2);
#endif
}

static __device__ __noinline__ BFp2 sqr(BFp2 a) {
#if defined(__CUDA_ARCH__)
  uint32_t x[24], r[24];
#pragma unroll
  for (int k = 0; k < 12; ++k) x[k] = a.c0.v[k], x[12 + k] = a.c1.v[k];
  ptx_sqr_bls_fq2(r, x);
  BFp2 o;
#pragma unroll
  for (int k = 0; k < 12; ++k) o.c0.v[k] = r[k], o.c1.v[k] = r[12 + k];
  return o;
#else
  return fq2_sqr_host<BFp, BFp2>(a, BLS_FQ_P, BLS_FQ_PINV);
#endif
}

// ---------------------------------------------------------------------------
// Jacobian group law, generic over Fp / Fp2
// ---------------------------------------------------------------------------

template <class F>
__device__ __forceinline__ Jac<F> jac_infinity();

template <>
__device__ __forceinline__ Jac<Fp> jac_infinity<Fp>() {
  return {fp_zero(), fp_one(), fp_zero()};
}

template <>
__device__ __forceinline__ Jac<Fp2> jac_infinity<Fp2>() {
  return {fp2_zero(), fp2_one(), fp2_zero()};
}

template <>
__device__ __forceinline__ Jac<BFp> jac_infinity<BFp>() {
  return {bfp_zero(), bfp_one(), bfp_zero()};
}

template <>
__device__ __forceinline__ Jac<BFp2> jac_infinity<BFp2>() {
  return {bfp2_zero(), bfp2_one(), bfp2_zero()};
}

// dbl-2009-l; infinity maps to infinity (z3 = 2yz = 0)
template <class F>
__device__ __noinline__ Jac<F> jac_double(Jac<F> p) {
  F a = sqr(p.x);
  F b = sqr(p.y);
  F c = sqr(b);
  F d = dbl(sub(sub(sqr(add(p.x, b)), a), c));
  F e = add(dbl(a), a);
  F z3 = dbl(mul(p.z, p.y));
  F x3 = sub(sqr(e), dbl(d));
  F c8 = dbl(dbl(dbl(c)));
  F y3 = sub(mul(sub(d, x3), e), c8);
  return {x3, y3, z3};
}

// add-2007-bl with the exceptional cases of curve/group.py jac_add
template <class F>
__device__ __noinline__ Jac<F> jac_add(Jac<F> p, Jac<F> q) {
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  F z1z1 = sqr(p.z);
  F z2z2 = sqr(q.z);
  F u1 = mul(p.x, z2z2);
  F u2 = mul(q.x, z1z1);
  F s1 = mul(mul(p.y, q.z), z2z2);
  F s2 = mul(mul(q.y, p.z), z1z1);
  bool eq_x = eq(u1, u2);
  if (eq_x && eq(s1, s2)) return jac_double(p);  // P == Q
  F h = sub(u2, u1);
  F i = sqr(dbl(h));
  F j = mul(h, i);
  F r = dbl(sub(s2, s1));
  F v = mul(u1, i);
  F x3 = sub(sub(sqr(r), j), dbl(v));
  F y3 = sub(mul(sub(v, x3), r), dbl(mul(s1, j)));
  F z3 = mul(sub(sub(sqr(add(p.z, q.z)), z1z1), z2z2), h);
  if (eq_x) z3 = sub(z3, z3);  // P == -Q: infinity, x3 and y3 as computed
  return {x3, y3, z3};
}

// madd-2007-bl: P + (qx, qy) for an affine Q, with the exceptional cases of
// curve/group.py jac_madd: P at infinity takes Q with z = 1, P == Q doubles,
// P == -Q gives z = 0 (x3 and y3 as computed)
template <class F>
__device__ __noinline__ Jac<F> jac_madd(Jac<F> p, F qx, F qy) {
  if (is_zero(p.z)) return {qx, qy, jac_infinity<F>().y};
  F z1z1 = sqr(p.z);
  F u2 = mul(qx, z1z1);
  F s2 = mul(mul(qy, p.z), z1z1);
  bool eq_x = eq(p.x, u2);
  if (eq_x && eq(p.y, s2)) return jac_double(p);  // P == Q
  F h = sub(u2, p.x);
  F hh = sqr(h);
  F i = dbl(dbl(hh));
  F j = mul(h, i);
  F r = dbl(sub(s2, p.y));
  F v = mul(p.x, i);
  F x3 = sub(sub(sqr(r), j), dbl(v));
  F y3 = sub(mul(sub(v, x3), r), dbl(mul(p.y, j)));
  F z3 = sub(sub(sqr(add(p.z, h)), z1z1), hh);
  if (eq_x) z3 = sub(z3, z3);  // P == -Q: infinity
  return {x3, y3, z3};
}

// ---------------------------------------------------------------------------
// exponentiation by a public exponent of W little-endian 32-bit limbs (8:
// 256 bits, BN254's; 12: 384 bits, BLS12-381's), square-and-multiply from
// the most significant bit
// ---------------------------------------------------------------------------

template <class F, int W = 8>
__device__ F pow_public(const F& a, const uint32_t* e, F one) {
  F r = one;
  bool started = false;
  for (int i = 32 * W - 1; i >= 0; --i) {
    if (started) r = sqr(r);
    if ((e[i >> 5] >> (i & 31)) & 1u) {
      r = started ? mul(r, a) : a;
      started = true;
    }
  }
  return r;
}

// a > b as integers (canonical values)
__device__ __forceinline__ bool gt(const Fp& a, const Fp& b) {
  for (int i = 7; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return false;
}

__device__ __forceinline__ bool gt(const BFp& a, const BFp& b) {
  for (int i = 11; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return false;
}

// ---------------------------------------------------------------------------
// 2N x 16-bit int64 digits (the tensors' layout) <-> N x 32-bit limbs
// ---------------------------------------------------------------------------

// On the card each access is 16 bytes, two digits: every caller passes an
// element of a contiguous int64 (..., 2N) tensor, whose elements lie 16 N
// bytes apart from an aligned base.
template <class E>
__device__ __forceinline__ E load_limbs(const int64_t* d) {
  E r;
#if defined(__CUDA_ARCH__)
  const longlong2* q = reinterpret_cast<const longlong2*>(d);
#pragma unroll
  for (int k = 0; k < kLimbs<E>; ++k) {
    const longlong2 t = q[k];
    r.v[k] = (uint32_t)t.x | ((uint32_t)t.y << 16);
  }
#else
#pragma unroll
  for (int k = 0; k < kLimbs<E>; ++k) r.v[k] = (uint32_t)d[2 * k] | ((uint32_t)d[2 * k + 1] << 16);
#endif
  return r;
}

template <class E>
__device__ __forceinline__ void store_limbs(int64_t* d, const E& a) {
#if defined(__CUDA_ARCH__)
  longlong2* q = reinterpret_cast<longlong2*>(d);
#pragma unroll
  for (int k = 0; k < kLimbs<E>; ++k) q[k] = make_longlong2(a.v[k] & 0xFFFF, a.v[k] >> 16);
#else
#pragma unroll
  for (int k = 0; k < kLimbs<E>; ++k) {
    d[2 * k] = a.v[k] & 0xFFFF;
    d[2 * k + 1] = a.v[k] >> 16;
  }
#endif
}

__device__ __forceinline__ Fp load_fp(const int64_t* d) { return load_limbs<Fp>(d); }
__device__ __forceinline__ void store_fp(int64_t* d, const Fp& a) { store_limbs(d, a); }
__device__ __forceinline__ Fr load_fr(const int64_t* d) { return load_limbs<Fr>(d); }
__device__ __forceinline__ void store_fr(int64_t* d, const Fr& a) { store_limbs(d, a); }

// Fq2 as 32 digits, c0 then c1 (the tensors' (..., 2, 16) layout)
__device__ __forceinline__ void load_el(const int64_t* d, Fp& a) { a = load_fp(d); }
__device__ __forceinline__ void load_el(const int64_t* d, Fp2& a) { a = {load_fp(d), load_fp(d + 16)}; }
__device__ __forceinline__ void store_el(int64_t* d, const Fp& a) { store_fp(d, a); }
__device__ __forceinline__ void store_el(int64_t* d, const Fp2& a) {
  store_fp(d, a.c0);
  store_fp(d + 16, a.c1);
}

// BLS12-381: Fq as 24 digits, Fq2 as 48 (c0 then c1)
__device__ __forceinline__ void load_el(const int64_t* d, BFp& a) { a = load_limbs<BFp>(d); }
__device__ __forceinline__ void load_el(const int64_t* d, BFp2& a) {
  a = {load_limbs<BFp>(d), load_limbs<BFp>(d + 24)};
}
__device__ __forceinline__ void store_el(int64_t* d, const BFp& a) { store_limbs(d, a); }
__device__ __forceinline__ void store_el(int64_t* d, const BFp2& a) {
  store_limbs(d, a.c0);
  store_limbs(d + 24, a.c1);
}

// int64 digits per element: 16 for Fq, 32 for Fq2 (BLS12-381: 24, 48)
template <class F>
constexpr int kDigits = (int)(sizeof(F) / 2);

// element i of three coordinate arrays <-> a Jacobian point
template <class F>
__device__ __forceinline__ Jac<F> load_jac(const int64_t* x, const int64_t* y, const int64_t* z, int64_t i) {
  Jac<F> p;
  load_el(x + kDigits<F> * i, p.x);
  load_el(y + kDigits<F> * i, p.y);
  load_el(z + kDigits<F> * i, p.z);
  return p;
}

template <class F>
__device__ __forceinline__ void store_jac(int64_t* x, int64_t* y, int64_t* z, int64_t i, const Jac<F>& p) {
  store_el(x + kDigits<F> * i, p.x);
  store_el(y + kDigits<F> * i, p.y);
  store_el(z + kDigits<F> * i, p.z);
}
