// A check of the field code itself, not a port of a TPU kernel: one thread
// per pair (a_i, b_i) of Fq, Fr or Fq2 elements (BN254; or BLS12-381 Fq, Fq2)
// computes a b, a^2, a + b and a - b with field.cuh's arithmetic. On the card that is the PTX of
// field_ptx.cuh; compiled by a host C++ compiler, the C++ code. ops/
// fieldops.py holds both against field/fp.py, so the two codes for one
// product are compared wherever a card is. Bound by nothing worth
// measuring: it exists to be exact on edge operands.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

template <class F>
__device__ __forceinline__ void field_ops_el(const int64_t* a, const int64_t* b, int64_t* prod, int64_t* sq,
                                             int64_t* sum, int64_t* diff, int64_t i) {
  F x, y;
  load_el(a + kDigits<F> * i, x);
  load_el(b + kDigits<F> * i, y);
  store_el(prod + kDigits<F> * i, mul(x, y));
  store_el(sq + kDigits<F> * i, sqr(x));
  store_el(sum + kDigits<F> * i, add(x, y));
  store_el(diff + kDigits<F> * i, sub(x, y));
}

// pair i; field 0 is Fq, 1 is Fr, 2 is Fq2, 3 BLS12-381 Fq, 4 BLS12-381
// Fq2; int64 (N, 16) 16-bit digits in and out ((N, 2, 16) for Fq2; (N, 24),
// (N, 2, 24) for BLS12-381)
__device__ void field_ops_pair(const int64_t* a, const int64_t* b, int64_t* prod, int64_t* sq, int64_t* sum,
                               int64_t* diff, int64_t i, int field) {
  if (field == 3) {
    field_ops_el<BFp>(a, b, prod, sq, sum, diff, i);
  } else if (field == 4) {
    field_ops_el<BFp2>(a, b, prod, sq, sum, diff, i);
  } else if (field == 0) {
    Fp x = load_fp(a + 16 * i), y = load_fp(b + 16 * i);
    store_fp(prod + 16 * i, mul(x, y));
    store_fp(sq + 16 * i, sqr(x));
    store_fp(sum + 16 * i, add(x, y));
    store_fp(diff + 16 * i, sub(x, y));
  } else if (field == 2) {
    Fp2 x, y;
    load_el(a + 32 * i, x);
    load_el(b + 32 * i, y);
    store_el(prod + 32 * i, mul(x, y));
    store_el(sq + 32 * i, sqr(x));
    store_el(sum + 32 * i, add(x, y));
    store_el(diff + 32 * i, sub(x, y));
  } else {
    Fr x = load_fr(a + 16 * i), y = load_fr(b + 16 * i);
    store_fr(prod + 16 * i, mul(x, y));
    store_fr(sq + 16 * i, sqr_inline(x));
    store_fr(sum + 16 * i, add(x, y));
    store_fr(diff + 16 * i, sub(x, y));
  }
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
field_ops_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ prod,
                 int64_t* __restrict__ sq, int64_t* __restrict__ sum, int64_t* __restrict__ diff, int n, int field) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) field_ops_pair(a, b, prod, sq, sum, diff, i, field);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int p2_field_ops(const void* a, const void* b, void* prod, void* sq, void* sum, void* diff, int n,
                            int field, void* stream) {
  if (field < 0 || field > 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    field_ops_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)prod, (int64_t*)sq, (int64_t*)sum, (int64_t*)diff, n,
        field);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
