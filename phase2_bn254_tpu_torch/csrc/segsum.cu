// S1: one round of the segmented inclusive scan of Jacobian points, G1 and
// G2, one thread per lane.
//
// Replaces the XLA glue phase2_bn254_tpu/ops/segsum.py _seg_scan_last (not a
// Pallas kernel): the phase-2 QAP evaluation sums the products k_t P_t of
// the terms of each variable. Terms are sorted by segment (variable); lane i
// knows start[i], the first lane of its segment. Round d (d = 1, 2, 4, ...
// below N) computes
//   out[i] = in[i] + in[i - d]   if i - d >= start[i]
//   out[i] = in[i]               otherwise
// with the complete Jacobian add of field.cuh (P + O, O + Q, P == Q by
// doubling, P == -Q to infinity), in[i] first, as the JAX scan adds: after
// log2 N rounds (double-buffered, one launch each) the last lane of each
// segment holds the segment's sum, equal limb for limb to the plain version.
// In: x, y, z int64 (N, 16) or (N, 2, 16), Jacobian, Montgomery; start
// int64 (N,). Out: the same shapes.
//
// What bounds it on the card: 32-bit integer multiply throughput, one
// Jacobian add per live lane per round (N log2 N adds at most), and the
// round's read and write of all N points. The design keeps every round
// a full-width pass of independent lanes, so a skewed segment (a third of a
// circuit's terms on one variable) costs what any other does: no thread
// walks a segment. A block-level segmented reduce would do N adds in all
// instead of N log2 N; that is later work.
//
// Outside nvcc (no __CUDACC__) only the per-lane function is compiled, so a
// host C++ compiler can run the arithmetic on the CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// Lane i of round d.
template <class F>
__device__ void seg_scan_lane(const int64_t* ix, const int64_t* iy, const int64_t* iz, const int64_t* start,
                              int64_t* ox, int64_t* oy, int64_t* oz, int64_t i, int64_t d) {
  Jac<F> p = load_jac<F>(ix, iy, iz, i);
  if (i - d >= start[i]) p = jac_add(p, load_jac<F>(ix, iy, iz, i - d));
  store_jac(ox, oy, oz, i, p);
}

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const int64_t* __restrict__ ix, const int64_t* __restrict__ iy, const int64_t* __restrict__ iz,
                const int64_t* __restrict__ start, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                int64_t* __restrict__ oz, int n, int d) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) seg_scan_lane<F>(ix, iy, iz, start, ox, oy, oz, i, d);
}

template <class F>
int launch_round(const void* ix, const void* iy, const void* iz, const void* start, void* ox, void* oy, void* oz,
                 int n, int d, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    seg_scan_kernel<F><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)ix, (const int64_t*)iy, (const int64_t*)iz, (const int64_t*)start, (int64_t*)ox,
        (int64_t*)oy, (int64_t*)oz, n, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch round d of S1 on `stream`; each returns cudaGetLastError() after
// the launch.
extern "C" int p2_seg_scan_round_g1(const void* ix, const void* iy, const void* iz, const void* start, void* ox,
                                    void* oy, void* oz, int n, int d, void* stream) {
  return launch_round<Fp>(ix, iy, iz, start, ox, oy, oz, n, d, stream);
}

extern "C" int p2_seg_scan_round_g2(const void* ix, const void* iy, const void* iz, const void* start, void* ox,
                                    void* oy, void* oz, int n, int d, void* stream) {
  return launch_round<Fp2>(ix, iy, iz, start, ox, oy, oz, n, d, stream);
}
#endif  // __CUDACC__
