// BN254 constants as 8 little-endian 32-bit limbs (FQ_P2 16), Montgomery form
// (R = 2^256) except FQ_P, FR_P, FR_HALF, FQ_R2, FQ_P2 and the EXP_ exponents; the
// BLS12-381 ones (BLS_) on 12 limbs for Fq and its exponents (24 for q^2), 8 for Fr,
// R = 2^384, with the same exceptions. Written by
// ops/_build.py constants_header() from the refimpl and bls12_381.field / glv integers;
// tests/test_torch_batch_exp.py checks it.
#pragma once

#include <cstdint>

static constexpr uint32_t FQ_PINV = 0xe4866389u;  // -q^-1 mod 2^32
static constexpr uint32_t FR_PINV = 0xefffffffu;  // -r^-1 mod 2^32
static constexpr uint32_t BLS_FQ_PINV = 0xfffcfffdu;  // BLS12-381: -q^-1 mod 2^32
// the modulus q
static __constant__ uint32_t FQ_P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// R mod q (Montgomery one)
static __constant__ uint32_t FQ_ONE[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// beta, phi(x, y) = (beta x, y) on G1
static __constant__ uint32_t GLV_BETA[8] = {0xd782e155u, 0x71930c11u, 0xffbe3323u, 0xa6bb947cu, 0xd4741444u, 0xaa303344u, 0x26594943u, 0x2c3b3f0du};
// C1 = xi^((q-1)/3), psi's x factor
static __constant__ uint32_t GLS_C1_C0[8] = {0x4563ab30u, 0xb5773b10u, 0xa9aa6454u, 0x347f91c8u, 0x242e0991u, 0x7a007127u, 0x118214ecu, 0x1956bcd8u};
static __constant__ uint32_t GLS_C1_C1[8] = {0xa0aa4757u, 0x6e849f1eu, 0x89f89141u, 0xaa1c7b6du, 0xfae0ca3au, 0xb6e713cdu, 0x4e82ebc3u, 0x26694fbbu};
// C2 = xi^((q-1)/2), psi's y factor
static __constant__ uint32_t GLS_C2_C0[8] = {0x2936b629u, 0xe4bbdd0cu, 0xe133bacbu, 0xbb30f162u, 0xf9645366u, 0x31a9d1b6u, 0xa500f8ddu, 0x253570beu};
static __constant__ uint32_t GLS_C2_C1[8] = {0x5ffe77c7u, 0xa1d77ce4u, 0x7826d1dbu, 0x07affd11u, 0xbb7edc6bu, 0x6d16bd27u, 0x85defeccu, 0x2c872002u};
// N1 = C1 conj(C1), in Fq: psi^2's x factor
static __constant__ uint32_t GLS_N1[8] = {0x13e80b9cu, 0x3350c88eu, 0xdb5e56b9u, 0x7dce557cu, 0xb615564au, 0x6001b4b8u, 0x020217e0u, 0x2682e617u};
// N2 = C2 conj(C2), in Fq: psi^2's y factor
static __constant__ uint32_t GLS_N2[8] = {0x12edefaau, 0x68c34889u, 0x72aabf4fu, 0x8d087f68u, 0x09081231u, 0x51e1a247u, 0x4729c0fau, 0x2259d6b1u};
// C31 = N1 C1, psi^3's x factor
static __constant__ uint32_t GLS_C31_C0[8] = {0x16ad6badu, 0xc9af22f7u, 0x4aa662b2u, 0xb311782au, 0xe248c7f4u, 0x19eeaf64u, 0xe3439f82u, 0x20273e77u};
static __constant__ uint32_t GLS_C31_C1[8] = {0xf7ce93acu, 0xacc02860u, 0x7ba76b4cu, 0x3933d581u, 0x446c8467u, 0x69e6188bu, 0x4417cc55u, 0x0a46036du};
// C32 = N2 C2, psi^3's y factor
static __constant__ uint32_t GLS_C32_C0[8] = {0xaf46471eu, 0x5764af0au, 0x873e0fc1u, 0xdc50792eu, 0x881d04f6u, 0x86a673ffu, 0x3c30a74cu, 0x0b2eddb4u};
static __constant__ uint32_t GLS_C32_C1[8] = {0x787e8580u, 0x9a490f32u, 0xf04af8b1u, 0x8fd16d7fu, 0xc6027bf2u, 0x4b39888eu, 0x5b52a15du, 0x03dd2e70u};
// b = 3 of G1: y^2 = x^3 + b
static __constant__ uint32_t B_G1[8] = {0x50ad28d7u, 0x7a17caa9u, 0xe15521b9u, 0x1f6ac17au, 0x696bd284u, 0x334bea4eu, 0xce179d8eu, 0x2a1f6744u};
// b = 3 / (9 + u) of G2
static __constant__ uint32_t B_G2_C0[8] = {0x77b802a8u, 0x3bf938e3u, 0x3633535du, 0x020b1b27u, 0x49755260u, 0x26b7edf0u, 0x4384a86du, 0x2514c632u};
static __constant__ uint32_t B_G2_C1[8] = {0xd1dcff67u, 0x38e7ecccu, 0x93ce0d3eu, 0x65f0b37du, 0x22ac00aau, 0xd749d0ddu, 0x4a688d4du, 0x0141b9ceu};
// -1
static __constant__ uint32_t FQ_NEG_ONE[8] = {0x12edefaau, 0x68c34889u, 0x72aabf4fu, 0x8d087f68u, 0x09081231u, 0x51e1a247u, 0x4729c0fau, 0x2259d6b1u};
// R^2 mod q as an integer (to Montgomery form: multiply by it)
static __constant__ uint32_t FQ_R2[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u, 0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};
// exponent (q + 1) / 4, an integer: the G1 square root
static __constant__ uint32_t EXP_SQRT_G1[8] = {0xb61f3f52u, 0x4f082305u, 0x5a1c72a3u, 0x65e05aa4u, 0xa0605617u, 0x6e14116du, 0xb84c680au, 0x0c19139cu};
// exponent (q - 3) / 4: a1 of the G2 square root
static __constant__ uint32_t EXP_G2_A1[8] = {0xb61f3f51u, 0x4f082305u, 0x5a1c72a3u, 0x65e05aa4u, 0xa0605617u, 0x6e14116du, 0xb84c680au, 0x0c19139cu};
// exponent (q - 1) / 2: the G2 square root's (1 + alpha) power
static __constant__ uint32_t EXP_G2_B[8] = {0x6c3e7ea3u, 0x9e10460bu, 0xb438e546u, 0xcbc0b548u, 0x40c0ac2eu, 0xdc2822dbu, 0x7098d014u, 0x18322739u};
// the scalar field's modulus r
static __constant__ uint32_t FR_P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// R mod r (Montgomery one of Fr)
static __constant__ uint32_t FR_ONE[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, 0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// (r - 1) / 2 as an integer: the windowed ladders take k above it as (r - k)(-P)
static __constant__ uint32_t FR_HALF[8] = {0xf8000000u, 0xa1f0fac9u, 0x3cdcb848u, 0x9419f424u, 0x40c0ac2eu, 0xdc2822dbu, 0x7098d014u, 0x18322739u};
// q^2 as an integer, 16 limbs: the offset of the Fq2 product's c0 (host path)
static __constant__ uint32_t FQ_P2[16] = {0x275d69b1u, 0x3b5458a2u, 0x09eac101u, 0xa602072du, 0x6d96cadcu, 0x4a50189cu, 0x7a1242c8u, 0x04689e95u, 0x34c6b38du, 0x26edfa5cu, 0x16375606u, 0xb00b8551u, 0x0348d21cu, 0x599a6f7cu, 0x763cbf9cu, 0x0925c4b8u};
// BLS12-381: the modulus q, 12 limbs
static __constant__ uint32_t BLS_FQ_P[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// 2^384 mod q (Montgomery one, R = 2^384)
static __constant__ uint32_t BLS_FQ_ONE[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// q^2 as an integer, 24 limbs: the offset of the Fq2 product's c0 (host path)
static __constant__ uint32_t BLS_FQ_P2[24] = {0x1c718e39u, 0x26aa0000u, 0x76382eabu, 0x7ced6b1du, 0x62113cfdu, 0x162c3383u, 0x3e71b743u, 0x66bf91edu, 0x7091a049u, 0x292e85a8u, 0x86185c7bu, 0x1d68619cu, 0x0978ef01u, 0xf5314933u, 0x16ddca6eu, 0x50a62cfdu, 0x349e8bd0u, 0x66e59e49u, 0x0e7046b4u, 0xe2dc90e5u, 0xa22f25e9u, 0x4bd278eau, 0xb8c35fc7u, 0x02a437a4u};
// the scalar field's modulus r, 8 limbs
static __constant__ uint32_t BLS_FR_P[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// (r - 1) / 2 as an integer: the windowed ladders take k above it as (r - k)(-P)
static __constant__ uint32_t BLS_FR_HALF[8] = {0x80000000u, 0x7fffffffu, 0x7fff2dffu, 0xa9ded201u, 0x04d0ec02u, 0x199cec04u, 0x94cebea4u, 0x39f6d3a9u};
// beta, phi(x, y) = (beta x, y) on G1 (bls12_381/glv.py)
static __constant__ uint32_t BLS_GLV_BETA[12] = {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u};
// b = 4 of G1
static __constant__ uint32_t BLS_B_G1[12] = {0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
// b = 4 (1 + u) of G2
static __constant__ uint32_t BLS_B_G2_C0[12] = {0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
static __constant__ uint32_t BLS_B_G2_C1[12] = {0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
// -1
static __constant__ uint32_t BLS_FQ_NEG_ONE[12] = {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u};
// R^2 mod q as an integer (to Montgomery form: multiply by it)
static __constant__ uint32_t BLS_FQ_R2[12] = {0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
// exponent (q + 1) / 4, an integer: the G1 square root
static __constant__ uint32_t BLS_EXP_SQRT_G1[12] = {0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au};
// exponent (q - 3) / 4: a1 of the G2 square root
static __constant__ uint32_t BLS_EXP_G2_A1[12] = {0xffffeaaau, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au};
// exponent (q - 1) / 2: the G2 square root's (1 + alpha) power
static __constant__ uint32_t BLS_EXP_G2_B[12] = {0xffffd555u, 0xdcff7fffu, 0x58a9ffffu, 0x0f55ffffu, 0x7b587b12u, 0xb3986950u, 0x79c2895fu, 0xb23ba5c2u, 0x21a5d66bu, 0x258dd3dbu, 0x1cbff34du, 0x0d0088f5u};
