// K6: one pass of the four-step radix-2 DIT Fr DFT, one thread block per row.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_ntt.py _lane_dft_pass
// (_lane_dft_kernel), driven by ntt_pallas; ops/ntt.py `ntt` runs two passes.
// A pass views its input as `rows` rows of C = 2^log2c Fr elements,
// X[r, j] = in[r * irs + j * ics], and writes, for every row r and k < C,
//   Y[r, k] = (sum_j X[r, j] w^(j k)) * tw_lo[e & (2^lo_bits - 1)] * tw_hi[e >> lo_bits],  e = r k,
// to out[r * ors + k * ocs] (strides in elements; an element is 16 int64
// 16-bit digits, Montgomery form, fully reduced). w is the C-th root of unity
// whose powers w^j, j < C/2, are `stage_tw`; without tw_lo (a null pointer)
// the inter-twiddle factor is left out. For N = R C, pass 1 takes rows
// j1 < R of a[j1 + R j2], with the inter-twiddle w_N^(j1 k2) (times 1/N for
// the inverse, folded into tw_hi) and writes b[k2 R + j1]; pass 2 takes
// rows k2 < C of b and writes out[k2 + C k1]: the strided gather, the
// transpose and the twiddle of the four-step method are part of the passes.
//
// Each block loads its row into shared memory as 8 x 32-bit limbs (C <= 4096:
// 128 KiB, above the default 48 KiB, so the launch opts in), bit-reversed, runs
// the log2(C) butterfly stages there with a barrier between stages, then
// applies the inter-twiddle and stores in natural order.
//
// What bounds it on this card: 32-bit integer multiply throughput. A pass
// does C/2 log2(C) butterfly products per row and, when twiddled, 2 C
// inter-twiddle products; each Montgomery product is 264 32-bit multiplies.
// Its bytes (every element read and written once, 128 bytes each in the
// int64 digit layout) take less than half as long at the memory rate (exp 18).
// The design is the simple one: no register tiling of several stages, the
// twiddles read from global memory (they stay in L2), 4-way shared-memory
// bank conflicts on the 32-byte elements.
//
// Outside nvcc (no __CUDACC__) only the per-element functions are compiled,
// so a host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

__device__ __forceinline__ int bit_reverse(int j, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((j >> b) & 1) << (bits - 1 - b);
  return r;
}

// s[j] = X[row, bitrev(j)]
__device__ void dft_load(Fr* s, const int64_t* in, int64_t row, int j, int log2c, int64_t irs, int64_t ics) {
  s[j] = load_fr(in + 16 * (row * irs + (int64_t)bit_reverse(j, log2c) * ics));
}

// Butterfly b < C/2 of stage st (1-based): the pair (je, je + h), h = 2^(st-1),
// twiddle w_m^(je mod h) = w^((je mod h) C / m), m = 2^st.
__device__ void dft_butterfly(Fr* s, const int64_t* stage_tw, int log2c, int st, int b) {
  int h = 1 << (st - 1);
  int k = b & (h - 1);
  int je = ((b >> (st - 1)) << st) | k;
  Fr t = mul(s[je + h], load_fr(stage_tw + 16 * ((int64_t)k << (log2c - st))));
  Fr e = s[je];
  s[je] = add(e, t);
  s[je + h] = sub(e, t);
}

// out[row * ors + k * ocs] = s[k], times the inter-twiddle when tw_lo is set
__device__ void dft_store(const Fr* s, int64_t* out, int64_t row, int k, int64_t ors, int64_t ocs,
                          const int64_t* tw_lo, const int64_t* tw_hi, int lo_bits) {
  Fr v = s[k];
  if (tw_lo != nullptr) {
    int64_t e = row * k;
    v = mul(mul(v, load_fr(tw_lo + 16 * (e & ((1 << lo_bits) - 1)))), load_fr(tw_hi + 16 * (e >> lo_bits)));
  }
  store_fr(out + 16 * (row * ors + (int64_t)k * ocs), v);
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
lane_dft_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, const int64_t* __restrict__ stage_tw,
                const int64_t* __restrict__ tw_lo, const int64_t* __restrict__ tw_hi, int log2c, int lo_bits,
                int irs, int ics, int ors, int ocs) {
  extern __shared__ uint4 smem[];
  Fr* s = reinterpret_cast<Fr*>(smem);
  const int c = 1 << log2c;
  const int64_t row = blockIdx.x;
  for (int j = threadIdx.x; j < c; j += blockDim.x) dft_load(s, in, row, j, log2c, irs, ics);
  __syncthreads();
  for (int st = 1; st <= log2c; ++st) {
    for (int b = threadIdx.x; b < c / 2; b += blockDim.x) dft_butterfly(s, stage_tw, log2c, st, b);
    __syncthreads();
  }
  for (int k = threadIdx.x; k < c; k += blockDim.x) dft_store(s, out, row, k, ors, ocs, tw_lo, tw_hi, lo_bits);
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError() after the launch
// (or the error of the shared-memory opt-in).
extern "C" int p2_lane_dft(const void* in, void* out, const void* stage_tw, const void* tw_lo, const void* tw_hi,
                           int rows, int log2c, int lo_bits, int irs, int ics, int ors, int ocs, void* stream) {
  if (rows > 0) {
    const int c = 1 << log2c;
    const int threads = c / 2 < kThreads ? (c / 2 > 0 ? c / 2 : 1) : kThreads;
    const size_t smem = (size_t)c * sizeof(Fr);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(lane_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    lane_dft_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, (const int64_t*)stage_tw, (const int64_t*)tw_lo, (const int64_t*)tw_hi,
        log2c, lo_bits, irs, ics, ors, ocs);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
