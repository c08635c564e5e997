// K6: one pass of the k-pass (four-step) radix-2 DIT Fr DFT.
//
// Replaces the TPU kernel phase2_bn254_tpu/ops/pallas_ntt.py _lane_dft_pass
// (_lane_dft_kernel), driven by ntt_pallas; ops/ntt.py `four_step` runs one
// pass per entry of its pass plan (two up to exp 24, three above). A pass
// views its input as `rows` rows of C = 2^log2c Fr elements; row r splits
// as r_hi = r >> rlo_bits, r_lo = r mod 2^rlo_bits, and
//   X[r, j] = in[r_hi in_hi + r_lo in_lo + j in_col].
// It writes, for every row r and k < C,
//   Y[r, k] = (sum_j X[r, j] w^(j k)) T(r_lo k) G(a)   to out[a],
//   a = r_hi out_hi + r_lo out_lo + k out_col,
// where w is the C-th root of unity whose powers w^j, j < C/2, are `stage`,
// T(e) = tw_lo[e mod 2^tw_bits] tw_hi[e >> tw_bits] is the inter-twiddle of
// the four-step method (1/N of the inverse folded into its tables), and G(a) =
// fout_lo[a mod 2^fout_bits] fout_hi[a >> fout_bits] a factor by output
// address; each input X is first multiplied by F(i) = fin_lo[i mod
// 2^fin_bits] fin_hi[i >> fin_bits] at its input address i. A null table
// leaves its factor out. The prover's coset powers g^i are F on the first
// pass and its geninv^k (with 1/(g^N - 1)) G on the last, so a coset NTT is
// one `ntt` call with no pointwise pass around it.
//
// Elements: in and out are either the tensors' int64 layout (16 16-bit
// digits an element, 128 bytes) or packed (8 32-bit limbs, 32 bytes: the
// intermediates between passes), Montgomery form, fully reduced; the
// tables are packed.
//
// What bounds it on this card: 32-bit integer multiply throughput. A row's
// DFT does C/2 log2(C) Montgomery products (264 32-bit multiplies each),
// and each factor two more per element (its lo hi product, then the
// product with the element). Its bytes (every element read and written
// once) take less time at the memory rate. The design, for that:
// * a block holds E = max(C, 512) elements (E / C rows) in shared memory,
//   limb-planar (word l of element e at s[l][e], the column swizzled with
//   bits 5-6 of e), so that a warp's 32 lanes touch 32 banks in every
//   stage;
// * each thread runs radix-4 groups: two stages in registers between
//   barriers (ceil(log2(C) / 2) phases a row, a barrier between two);
//   radix-2 phases (50 registers where these take 114) ran 8-29% slower;
//   the first phase loads its four elements from device memory in
//   bit-reversed order and the last stores its four to device memory, so
//   the row makes one trip through shared memory fewer than it has phases;
// * twiddles are packed 32-byte entries read through the read-only cache
//   (every block reads the same table), three per radix-4 group, and a
//   twiddle of 1 (w^0, the whole first stage) is not multiplied;
// * the intermediates between passes are packed: 32 bytes where the int64
//   layout takes 128; the int64 elements move 16 bytes a load or store;
// * the factors' products run out of line (one copy for every load and
//   store), which keeps the kernel's code within the instruction cache;
// * at C = 4096 (exp 23 and 24) a block is 512 threads of 128 KiB, one a
//   SM; above exp 24 passes are at most 2^10 long, so a block is 512 or
//   1024 elements (16 or 32 KiB) and several fit on an SM;
// * a pass whose input and output addresses are the same (the middle pass
//   of three) may run in place: each block reads all its elements before it
//   writes any, and no two blocks share an element.
//
// Outside nvcc (no __CUDACC__) only the per-group functions are compiled,
// so a host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

#if !defined(__CUDACC__) && !defined(__host__)
#define __host__
#endif

struct NttPass {
  const void* in;
  void* out;
  const uint32_t* stage;
  const uint32_t* tw_lo;
  const uint32_t* tw_hi;
  const uint32_t* fin_lo;
  const uint32_t* fin_hi;
  const uint32_t* fout_lo;
  const uint32_t* fout_hi;
  int rows, log2c, rlo_bits, tw_bits, fin_bits, fout_bits;
  int64_t in_hi, in_lo, in_col, out_hi, out_lo, out_col;
  int in_packed, out_packed;
};

// elements a block holds: whole rows, at least 512 elements where there
// are enough rows (log2; on an H100 at exp 26 blocks of 1024 took 7% and
// of 2048 25% longer, the same at exp 20 and 24: scripts/bench_shapes.py)
__host__ __device__ inline int ntt_block_log(int log2c, int rows) {
  int e = log2c;
  while (e < 9 && (1 << (e - log2c)) < rows) ++e;
  return e;
}

// ---------------------------------------------------------------------------
// elements in device memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fr load_packed(const uint32_t* p, int64_t i) {
  Fr r;
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(p + 8 * i);
  uint4 a = __ldg(q), b = __ldg(q + 1);
  r.v[0] = a.x, r.v[1] = a.y, r.v[2] = a.z, r.v[3] = a.w;
  r.v[4] = b.x, r.v[5] = b.y, r.v[6] = b.z, r.v[7] = b.w;
#else
  for (int l = 0; l < 8; ++l) r.v[l] = p[8 * i + l];
#endif
  return r;
}

__device__ __forceinline__ void store_packed(uint32_t* p, int64_t i, const Fr& a) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(p + 8 * i);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
#else
  for (int l = 0; l < 8; ++l) p[8 * i + l] = a.v[l];
#endif
}

// v * lo[e mod 2^bits] * hi[e >> bits]; one out-of-line copy of its two
// products serves every load and store of the kernel
__device__ __noinline__ Fr times_factor(Fr v, const uint32_t* lo, const uint32_t* hi, int bits, int64_t e) {
  return mul(v, mul(load_packed(lo, e & ((int64_t(1) << bits) - 1)), load_packed(hi, e >> bits)));
}

__device__ __forceinline__ int64_t pass_addr(int r, int rlo_bits, int64_t s_hi, int64_t s_lo, int64_t s_col, int j) {
  return (int64_t)(r >> rlo_bits) * s_hi + (int64_t)(r & ((1 << rlo_bits) - 1)) * s_lo + (int64_t)j * s_col;
}

// X[r, j], times its load factor
__device__ __forceinline__ Fr pass_load(const NttPass& a, int r, int j) {
  const int64_t i = pass_addr(r, a.rlo_bits, a.in_hi, a.in_lo, a.in_col, j);
  Fr v = a.in_packed ? load_packed((const uint32_t*)a.in, i) : load_limbs<Fr>((const int64_t*)a.in + 16 * i);
  if (a.fin_lo != nullptr) v = times_factor(v, a.fin_lo, a.fin_hi, a.fin_bits, i);
  return v;
}

// Y[r, k] = v times the inter-twiddle and the store factor, to its address
__device__ __forceinline__ void pass_store(const NttPass& a, int r, int k, Fr v) {
  const int64_t i = pass_addr(r, a.rlo_bits, a.out_hi, a.out_lo, a.out_col, k);
  if (a.tw_lo != nullptr)
    v = times_factor(v, a.tw_lo, a.tw_hi, a.tw_bits, (int64_t)(r & ((1 << a.rlo_bits) - 1)) * k);
  if (a.fout_lo != nullptr) v = times_factor(v, a.fout_lo, a.fout_hi, a.fout_bits, i);
  if (a.out_packed)
    store_packed((uint32_t*)a.out, i, v);
  else
    store_limbs((int64_t*)a.out + 16 * i, v);
}

// ---------------------------------------------------------------------------
// shared memory: limb-planar, s[l * E + col(e)]
// ---------------------------------------------------------------------------

// bits 5-6 of e XORed into bits 0-1 and 2-3: the strided stages (h = 1, 4,
// 16 elements apart) then touch 32 banks, and a warp reading 32
// consecutive elements still does
__device__ __forceinline__ int smem_col(int e) { return e ^ (((e >> 5) & 3) * 5); }

__device__ __forceinline__ Fr smem_load(const uint32_t* s, int block_log, int e) {
  Fr r;
  const int c = smem_col(e);
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = s[(l << block_log) + c];
  return r;
}

__device__ __forceinline__ void smem_store(uint32_t* s, int block_log, int e, const Fr& a) {
  const int c = smem_col(e);
#pragma unroll
  for (int l = 0; l < 8; ++l) s[(l << block_log) + c] = a.v[l];
}

__device__ __forceinline__ int bit_reverse(int j, int bits) {
#if defined(__CUDA_ARCH__)
  return bits ? (int)(__brev((unsigned)j) >> (32 - bits)) : 0;
#else
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((j >> b) & 1) << (bits - 1 - b);
  return r;
#endif
}

// w_{2^st}^k from the stage table of a C = 2^log2c pass
__device__ __forceinline__ Fr stage_twiddle(const NttPass& a, int st, int k) {
  return load_packed(a.stage, (int64_t)k << (a.log2c - st));
}

// One group of phase `ph` in the block whose first row is row0: phase ph
// runs stages s = 2 ph + 1 and s + 1 (radix 4) on the positions base + m h,
// h = 2^(s - 1), or stage s alone (radix 2) when it is the last and
// log2(C) is odd. Positions are bit-reversed indices in the first phase
// (read from device memory) and natural ones after the last (written to
// it); between phases the row lives in shared memory.
__device__ void ntt_group(const NttPass& a, uint32_t* s, int block_log, int row0, int ph, int g) {
  const int L = a.log2c;
  const int last = (L - 1) / 2;
  const int st = 2 * ph + 1;
  const bool r4 = st < L;
  const int radix_log = r4 ? 2 : 1;
  const int per_row_log = L - radix_log;  // groups a row
  const int rb = g >> per_row_log;
  const int q = g & ((1 << per_row_log) - 1);
  const int r = row0 + rb;
  if (r >= a.rows) return;
  const int h = 1 << (st - 1);
  const int lo = q & (h - 1);
  const int base = ((q >> (st - 1)) << (st - 1 + radix_log)) | lo;
  const int e0 = rb << L;  // the row's first element in the block
  Fr v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int p = base + m * h;
    if (m < (1 << radix_log)) v[m] = ph == 0 ? pass_load(a, r, bit_reverse(p, L)) : smem_load(s, block_log, e0 + p);
  }
  if (r4) {
    // stage st: (0, 1) and (2, 3) with w_{2h}^lo; stage st + 1: (0, 2) with
    // w_{4h}^lo and (1, 3) with w_{4h}^(lo + h)
    Fr t1 = v[1], t3 = v[3];
    if (lo != 0) {
      const Fr w1 = stage_twiddle(a, st, lo);
      t1 = mul(t1, w1);
      t3 = mul(t3, w1);
    }
    v[1] = sub(v[0], t1);
    v[0] = add(v[0], t1);
    v[3] = sub(v[2], t3);
    v[2] = add(v[2], t3);
    Fr t2 = v[2];
    if (lo != 0) t2 = mul(t2, stage_twiddle(a, st + 1, lo));
    t3 = mul(v[3], stage_twiddle(a, st + 1, lo + h));
    v[2] = sub(v[0], t2);
    v[0] = add(v[0], t2);
    v[3] = sub(v[1], t3);
    v[1] = add(v[1], t3);
  } else {
    Fr t1 = v[1];
    if (lo != 0) t1 = mul(t1, stage_twiddle(a, st, lo));
    v[1] = sub(v[0], t1);
    v[0] = add(v[0], t1);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int p = base + m * h;
    if (m >= (1 << radix_log))
      break;
    else if (ph == last)
      pass_store(a, r, p, v[m]);
    else
      smem_store(s, block_log, e0 + p, v[m]);
  }
}

// groups of phase ph in a block of 2^block_log elements
__host__ __device__ inline int ntt_phase_groups(int log2c, int block_log, int ph) {
  return 1 << (block_log - (2 * ph + 1 < log2c ? 2 : 1));
}

#ifdef __CUDACC__
namespace {

constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads) lane_dft_kernel(NttPass a, int block_log) {
  extern __shared__ uint32_t smem[];
  const int row0 = blockIdx.x << (block_log - a.log2c);
  const int phases = (a.log2c + 1) / 2;
  for (int ph = 0; ph < phases; ++ph) {
    const int groups = ntt_phase_groups(a.log2c, block_log, ph);
    for (int g = threadIdx.x; g < groups; g += blockDim.x) ntt_group(a, smem, block_log, row0, ph, g);
    if (ph + 1 < phases) __syncthreads();
  }
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError() after the launch
// (or the error of the shared-memory opt-in). Tables may be null (no factor).
extern "C" int p2_lane_dft(const void* in, void* out, const void* stage, const void* tw_lo, const void* tw_hi,
                           const void* fin_lo, const void* fin_hi, const void* fout_lo, const void* fout_hi,
                           int rows, int log2c, int rlo_bits, int tw_bits, int fin_bits, int fout_bits, int in_hi,
                           int in_lo, int in_col, int out_hi, int out_lo, int out_col, int in_packed,
                           int out_packed, void* stream) {
  if (rows > 0) {
    NttPass a{in, out, (const uint32_t*)stage, (const uint32_t*)tw_lo, (const uint32_t*)tw_hi,
              (const uint32_t*)fin_lo, (const uint32_t*)fin_hi, (const uint32_t*)fout_lo, (const uint32_t*)fout_hi,
              rows, log2c, rlo_bits, tw_bits, fin_bits, fout_bits, in_hi, in_lo, in_col, out_hi, out_lo, out_col,
              in_packed, out_packed};
    const int block_log = ntt_block_log(log2c, rows);
    const int rows_log = block_log - log2c;
    const int blocks = (rows + (1 << rows_log) - 1) >> rows_log;
    const int groups = ntt_phase_groups(log2c, block_log, 0);
    const int threads = groups < kMaxThreads ? groups : kMaxThreads;
    const size_t smem = (size_t)8 * sizeof(uint32_t) << block_log;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(lane_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    lane_dft_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a, block_log);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
