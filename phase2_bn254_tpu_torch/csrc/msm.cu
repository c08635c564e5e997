// K3, K4, K5: the Pippenger multi-scalar multiplication of the verify path,
// G1 (Fq) and G2 (Fq2), one C entry point per kernel and group.
//
// Replaces the TPU kernels of phase2_bn254_tpu/ops/pallas_msm.py:
//   K3 bucket_accumulate  <- _wave_accumulate (_wave_kernel)
//   K4 bucket_reduce      <- _suffix_reduce (_suffix_kernel)
//   K5 combine_windows    <- _combine_windows (_combine_kernel, without the
//                            hot-bucket fold)
// What the three compute is that of the TPU kernels; the TPU's dense wave
// grid (packed rows, the kernel-transpose mode, the wave cap and its host
// sync) is not carried over. ops/msm.py prepares the inputs: for each c-bit
// window w (least significant first) the point indices sorted by digit
// (`orders`, (nwin, N)), and each digit's start and count in that order
// ((nwin, B), B = 2^c). Lane l of window w covers digit l / g_w and
// sub-range l % g_w of that digit's run (g_w > 1 only in the top window,
// whose digits have fewer than c bits), as _msm_main assigns them.
//
// Every kernel computes S MSMs at once that share the scalars: set s takes
// the points shifts[s] .. shifts[s] + N - 1 of one array (power_pairs' v[:-1]
// and v[1:], S = 2).
// K3: one thread per (set, window, lane), all in one launch. The thread
//   walks its contiguous run of the sorted order and mixed-adds each affine
//   point (skipping points at infinity) into a Jacobian accumulator that
//   starts at infinity; digit-0 lanes stay at infinity. Out: (S, nwin, B)
//   Jacobian bucket sums.
// K4: one thread per (set, window): sum_l (l / g_w) S_l by summation by
//   parts, a serial running suffix sum added into the total at the
//   weight-step lanes (l % g_w == 0, l != 0). Out: (S, nwin) window sums.
// K5: one thread per set: sum_w 2^(c w) T_w, most significant window first,
//   with c doublings and one add per window. Out: (S) Jacobian points.
// All values Montgomery, fully reduced; int64 16-bit digits as the tensors.
//
// What bounds them on this card: 32-bit integer multiply throughput inside
// long per-thread chains of group operations (11 Montgomery products per
// mixed add, 16 per add, 7 per doubling). K3 has nwin * B threads (14,848 at
// the verify chunk's c = 9), fewer than the card holds, so it is bound by
// the latency of each thread's chain rather than by the multiplier rate;
// a skewed digit distribution puts long runs on a few threads (correct,
// only slower). K4 is nwin serial chains of 2 (B - 1) adds and K5 one chain
// of c * nwin doublings: both are latency-bound by design (simple first).
// G2 keeps its Jacobian accumulator (192 bytes) in registers. The point
// gathers of K3 (64 or 128 bytes per point through `orders`) hit the L2
// cache: a verify chunk's points are 4 or 8 MB.
//
// Outside nvcc (no __CUDACC__) only the per-thread functions are compiled,
// so a host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// K3, thread t = (s * nwin + w) * b + l
template <class F>
__device__ void bucket_accumulate_lane(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts,
                                       const int64_t* orders, const int64_t* starts, const int64_t* counts,
                                       const int64_t* groups, int64_t* ox, int64_t* oy, int64_t* oz, int64_t t,
                                       int n, int nwin, int b) {
  int64_t l = t % b, w = t / b % nwin, shift = shifts[t / b / nwin];
  int64_t g = groups[w], d = l / g, gr = l % g;
  Jac<F> acc = jac_infinity<F>();
  if (d != 0) {
    int64_t s = starts[w * b + d], cnt = counts[w * b + d];
    int64_t sub = (cnt + g - 1) / g;
    int64_t lo = s + gr * sub;
    int64_t hi = s + ((gr + 1) * sub < cnt ? (gr + 1) * sub : cnt);
    const int64_t* order = orders + w * n;
    for (int64_t pos = lo; pos < hi; ++pos) {
      int64_t i = order[pos] + shift;
      if (inf[i]) continue;
      F qx, qy;
      load_el(x + kDigits<F> * i, qx);
      load_el(y + kDigits<F> * i, qy);
      acc = jac_madd(acc, qx, qy);
    }
  }
  store_jac(ox, oy, oz, t, acc);
}

// K4, thread t = s * nwin + w
template <class F>
__device__ void bucket_reduce_window(const int64_t* bx, const int64_t* by, const int64_t* bz,
                                     const int64_t* groups, int64_t* ox, int64_t* oy, int64_t* oz, int64_t t,
                                     int nwin, int b) {
  int64_t g = groups[t % nwin];
  Jac<F> running = jac_infinity<F>(), total = jac_infinity<F>();
  for (int l = b - 1; l >= 1; --l) {
    running = jac_add(running, load_jac<F>(bx, by, bz, t * b + l));
    if (l % g == 0) total = jac_add(total, running);
  }
  store_jac(ox, oy, oz, t, total);
}

// K5, set s
template <class F>
__device__ void combine_windows_point(const int64_t* sx, const int64_t* sy, const int64_t* sz, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t s, int nwin, int c) {
  Jac<F> p = jac_infinity<F>();
  for (int w = nwin - 1; w >= 0; --w) {
    for (int k = 0; k < c; ++k) p = jac_double(p);
    p = jac_add(p, load_jac<F>(sx, sy, sz, s * nwin + w));
  }
  store_jac(ox, oy, oz, s, p);
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
bucket_accumulate_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y, const bool* __restrict__ inf,
                         const int64_t* __restrict__ shifts, const int64_t* __restrict__ orders,
                         const int64_t* __restrict__ starts, const int64_t* __restrict__ counts,
                         const int64_t* __restrict__ groups, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                         int64_t* __restrict__ oz, int nsets, int n, int nwin, int b) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < (int64_t)nsets * nwin * b)
    bucket_accumulate_lane<F>(x, y, inf, shifts, orders, starts, counts, groups, ox, oy, oz, t, n, nwin, b);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
bucket_reduce_kernel(const int64_t* __restrict__ bx, const int64_t* __restrict__ by,
                     const int64_t* __restrict__ bz, const int64_t* __restrict__ groups,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz, int nsets,
                     int nwin, int b) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < (int64_t)nsets * nwin) bucket_reduce_window<F>(bx, by, bz, groups, ox, oy, oz, t, nwin, b);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
combine_windows_kernel(const int64_t* __restrict__ sx, const int64_t* __restrict__ sy,
                       const int64_t* __restrict__ sz, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                       int64_t* __restrict__ oz, int nsets, int nwin, int c) {
  int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < nsets) combine_windows_point<F>(sx, sy, sz, ox, oy, oz, s, nwin, c);
}

inline int blocks_for(int64_t threads) { return (int)((threads + kThreads - 1) / kThreads); }

template <class F>
int launch_accumulate(const void* x, const void* y, const void* inf, const void* shifts, const void* orders,
                      const void* starts, const void* counts, const void* groups, void* ox, void* oy, void* oz,
                      int nsets, int n, int nwin, int b, void* stream) {
  int64_t threads = (int64_t)nsets * nwin * b;
  if (threads > 0) {
    bucket_accumulate_kernel<F><<<blocks_for(threads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const bool*)inf, (const int64_t*)shifts, (const int64_t*)orders,
        (const int64_t*)starts, (const int64_t*)counts, (const int64_t*)groups, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, nsets, n, nwin, b);
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_reduce(const void* bx, const void* by, const void* bz, const void* groups, void* ox, void* oy,
                  void* oz, int nsets, int nwin, int b, void* stream) {
  int64_t threads = (int64_t)nsets * nwin;
  if (threads > 0) {
    bucket_reduce_kernel<F><<<blocks_for(threads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)bx, (const int64_t*)by, (const int64_t*)bz, (const int64_t*)groups, (int64_t*)ox,
        (int64_t*)oy, (int64_t*)oz, nsets, nwin, b);
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_combine(const void* sx, const void* sy, const void* sz, void* ox, void* oy, void* oz, int nsets,
                   int nwin, int c, void* stream) {
  if (nsets > 0) {
    combine_windows_kernel<F><<<blocks_for(nsets), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)sx, (const int64_t*)sy, (const int64_t*)sz, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz,
        nsets, nwin, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch.
#define P2_MSM_ENTRY_POINTS(G, F)                                                                                 \
  extern "C" int p2_bucket_accumulate_##G(const void* x, const void* y, const void* inf, const void* shifts,      \
                                          const void* orders, const void* starts, const void* counts,          \
                                          const void* groups, void* ox, void* oy, void* oz, int nsets, int n,  \
                                          int nwin, int b, void* stream) {                                     \
    return launch_accumulate<F>(x, y, inf, shifts, orders, starts, counts, groups, ox, oy, oz, nsets, n, nwin, b, \
                                stream);                                                                       \
  }                                                                                                            \
  extern "C" int p2_bucket_reduce_##G(const void* bx, const void* by, const void* bz, const void* groups,         \
                                      void* ox, void* oy, void* oz, int nsets, int nwin, int b, void* stream) {  \
    return launch_reduce<F>(bx, by, bz, groups, ox, oy, oz, nsets, nwin, b, stream);                           \
  }                                                                                                            \
  extern "C" int p2_combine_windows_##G(const void* sx, const void* sy, const void* sz, void* ox, void* oy,       \
                                        void* oz, int nsets, int nwin, int c, void* stream) {                  \
    return launch_combine<F>(sx, sy, sz, ox, oy, oz, nsets, nwin, c, stream);                                  \
  }

P2_MSM_ENTRY_POINTS(g1, Fp)
P2_MSM_ENTRY_POINTS(g2, Fp2)
#endif  // __CUDACC__
