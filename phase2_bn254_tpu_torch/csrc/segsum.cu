// S1: the segment sums of Jacobian points, G1 and G2, as a one-pass
// segmented reduction.
//
// Replaces the XLA glue phase2_bn254_tpu/ops/segsum.py _seg_scan_last (not a
// Pallas kernel): the phase-2 QAP evaluation sums the products k_t P_t of
// the terms of each variable. Terms are sorted by segment (variable):
//   out[s] = sum of in[i] over the terms i with seg[i] == s
// with the complete Jacobian add of field.cuh (P + O, O + Q, P == Q by
// doubling, P == -Q to infinity). The adds run in another order than the
// JAX scan's, so a sum's Jacobian limbs may differ from the scan's; its
// affine point, and every byte written from it, is the same.
// In: x, y, z int64 (N, 16) or (N, 2, 16), Jacobian, Montgomery; seg int64
// (N,). Out: out x, y, z (S, ...) for the segments that have terms (the
// caller fills the others with infinity); carries, below.
//
// Design. A block takes a tile of T threads x K consecutive terms (one
// launch covers every tile):
// 1. each thread adds its K terms in order, starting afresh at each segment
//    boundary, and writes the sum of every segment that begins and ends
//    inside its run; it keeps the sums of its run's first segment (head)
//    and last segment (tail);
// 2. the block runs a segmented inclusive scan (Hillis-Steele, log2 T
//    steps in shared memory) over the threads' tail sums, flagged where a
//    thread's last segment begins in its own run;
// 3. each thread writes the sum of each segment that ends in its run: its
//    head added to the scanned tail of the thread before it, or its own
//    scanned tail. A segment that crosses into the tile from the one before
//    goes to the tile's carry slot 2 tile, the tile's last segment, where it
//    crosses into the next tile, to slot 2 tile + 1 (a tile inside one
//    segment: its sum in slot 2 tile, infinity in 2 tile + 1); an unused
//    slot holds infinity with segment -1.
// The carries (2 per tile) are again points sorted by segment, the entries
// of one segment contiguous: the next launch reduces them the same way,
// until one tile holds them all. A segment across m tiles costs log_(T K / 2)
// m launches, not a chain of m; a call is ceil(log_(T K / 2)(N / 2)) or so
// launches (2 at N = 2^16, 3 at 2^20 with the port's T K = 512).
//
// What bounds it on the card: 32-bit integer multiply throughput, one
// Jacobian add per term after its segment's first (a thread's adds and the
// scan's few more), and one read of the N points. No thread walks a
// segment longer than its run, so a skewed segment (a third of a circuit's
// terms on one variable) costs what any other does.
//
// Outside nvcc (no __CUDACC__) only the per-thread functions are compiled,
// so a host C++ compiler can run them on the CPU, a loop standing in for
// the block's threads and for the launches.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// A thread's run [lo, hi) of terms: the sums of its first segment (head,
// when the run holds more than one) and of its last (tail)
template <class F>
struct SegRun {
  Jac<F> head, tail;
  int64_t lo, hi;  // lo == hi: past the last term
  bool single;     // one segment: head unused
};

// Step 1 for the run of K = terms from lo
template <class F>
__device__ SegRun<F> seg_run(const int64_t* x, const int64_t* y, const int64_t* z, const int64_t* seg, int64_t n,
                             int64_t lo, int terms, int64_t* ox, int64_t* oy, int64_t* oz) {
  SegRun<F> r;
  r.lo = lo < n ? lo : n;
  r.hi = lo + terms < n ? lo + terms : n;
  r.single = true;
  r.head = r.tail = jac_infinity<F>();
  if (r.lo == r.hi) return r;
  Jac<F> acc = load_jac<F>(x, y, z, r.lo);
  int64_t cur = seg[r.lo];
  for (int64_t i = r.lo + 1; i < r.hi; ++i) {
    int64_t s = seg[i];
    Jac<F> p = load_jac<F>(x, y, z, i);
    if (s == cur) {
      acc = jac_add(acc, p);
      continue;
    }
    if (r.single) {
      r.head = acc;
      r.single = false;
    } else if (cur >= 0) {
      store_jac(ox, oy, oz, cur, acc);  // began and ended inside the run
    }
    acc = p;
    cur = s;
  }
  r.tail = acc;
  return r;
}

// The scan's flag of a run: its last segment begins inside it (or it is the
// tile's first run, or holds no terms)
template <class F>
__device__ bool seg_flag(const SegRun<F>& r, const int64_t* seg, int64_t tile_lo) {
  return r.lo == r.hi || !r.single || r.lo == tile_lo || seg[r.lo - 1] != seg[r.lo];
}

// Step 2, thread t at distance d: the new entry (nv, nf) where it changes
template <class F>
__device__ bool seg_scan_step(const Jac<F>* v, const uint8_t* f, int t, int d, Jac<F>& nv, uint8_t& nf) {
  if (t < d || f[t]) return false;
  nv = jac_add(v[t - d], v[t]);
  nf = f[t - d];
  return true;
}

template <class F>
__device__ __forceinline__ void seg_put_carry(int64_t* cx, int64_t* cy, int64_t* cz, int64_t* cseg, int64_t slot,
                                              int64_t s, const Jac<F>& p) {
  store_jac(cx, cy, cz, slot, p);
  cseg[slot] = s;
}

// The sum p of segment s, which ends in this tile: to the tile's carry slot
// if s began in an earlier tile, else to out (segment -1 is padding)
template <class F>
__device__ void seg_emit(int64_t s, const Jac<F>& p, const int64_t* seg, int64_t tile, int64_t tile_lo, int64_t* ox,
                         int64_t* oy, int64_t* oz, int64_t* cx, int64_t* cy, int64_t* cz, int64_t* cseg) {
  if (tile_lo > 0 && seg[tile_lo - 1] == s)
    seg_put_carry(cx, cy, cz, cseg, 2 * tile, s, p);
  else if (s >= 0)
    store_jac(ox, oy, oz, s, p);
}

// Step 3 for thread t of tile `tile` ([tile_lo, tile_hi)); v: the scanned
// tails
template <class F>
__device__ void seg_finish(const SegRun<F>& r, const Jac<F>* v, const int64_t* seg, int64_t n, int64_t tile,
                           int64_t tile_lo, int64_t tile_hi, int t, int64_t* ox, int64_t* oy, int64_t* oz, int64_t* cx,
                           int64_t* cy, int64_t* cz, int64_t* cseg) {
  if (r.lo == r.hi) return;
  if (t == 0 && !(tile_lo > 0 && seg[tile_lo - 1] == seg[tile_lo]))
    seg_put_carry(cx, cy, cz, cseg, 2 * tile, -1, jac_infinity<F>());
  if (!r.single) {
    int64_t s = seg[r.lo];
    Jac<F> p = r.head;
    if (t > 0 && seg[r.lo - 1] == s) p = jac_add(v[t - 1], p);
    seg_emit(s, p, seg, tile, tile_lo, ox, oy, oz, cx, cy, cz, cseg);
  }
  int64_t s = seg[r.hi - 1];
  if (r.hi < tile_hi) {
    if (seg[r.hi] != s) seg_emit(s, v[t], seg, tile, tile_lo, ox, oy, oz, cx, cy, cz, cseg);
    return;
  }
  bool in = tile_lo > 0 && seg[tile_lo - 1] == s, out = tile_hi < n && seg[tile_hi] == s;
  if (!out) {
    seg_emit(s, v[t], seg, tile, tile_lo, ox, oy, oz, cx, cy, cz, cseg);
    seg_put_carry(cx, cy, cz, cseg, 2 * tile + 1, -1, jac_infinity<F>());
  } else if (in) {
    seg_put_carry(cx, cy, cz, cseg, 2 * tile, s, v[t]);
    seg_put_carry(cx, cy, cz, cseg, 2 * tile + 1, s, jac_infinity<F>());
  } else {
    seg_put_carry(cx, cy, cz, cseg, 2 * tile + 1, s, v[t]);
  }
}

#ifdef __CUDACC__
namespace {

constexpr int kMaxThreads = 128;  // 128 G2 points in shared memory: 24.7 KB of the default 48

template <class F>
__global__ void __launch_bounds__(kMaxThreads)
segment_sums_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
                    const int64_t* __restrict__ seg, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                    int64_t* __restrict__ oz, int64_t* __restrict__ cx, int64_t* __restrict__ cy,
                    int64_t* __restrict__ cz, int64_t* __restrict__ cseg, int64_t n, int terms) {
  extern __shared__ __align__(16) unsigned char smem[];
  Jac<F>* v = reinterpret_cast<Jac<F>*>(smem);
  uint8_t* f = reinterpret_cast<uint8_t*>(v + blockDim.x);
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t tile = blockIdx.x, tile_lo = tile * T * terms;
  const int64_t tile_hi = tile_lo + (int64_t)T * terms < n ? tile_lo + (int64_t)T * terms : n;
  SegRun<F> r = seg_run<F>(x, y, z, seg, n, tile_lo + (int64_t)t * terms, terms, ox, oy, oz);
  v[t] = r.tail;
  f[t] = seg_flag(r, seg, tile_lo);
  __syncthreads();
  for (int d = 1; d < T; d *= 2) {
    Jac<F> nv;
    uint8_t nf;
    bool changed = seg_scan_step(v, f, t, d, nv, nf);
    __syncthreads();
    if (changed) {
      v[t] = nv;
      f[t] = nf;
    }
    __syncthreads();
  }
  seg_finish(r, v, seg, n, tile, tile_lo, tile_hi, t, ox, oy, oz, cx, cy, cz, cseg);
}

template <class F>
int launch_level(const void* x, const void* y, const void* z, const void* seg, void* ox, void* oy, void* oz, void* cx,
                 void* cy, void* cz, void* cseg, int n, int threads, int terms, void* stream) {
  if (threads < 1 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int64_t tile = (int64_t)threads * terms;
    int blocks = (int)((n + tile - 1) / tile);
    size_t shared = (size_t)threads * (sizeof(Jac<F>) + 1);
    segment_sums_kernel<F><<<blocks, threads, shared, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)z, (const int64_t*)seg, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, (int64_t*)cx, (int64_t*)cy, (int64_t*)cz, (int64_t*)cseg, n, terms);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of S1 over n entries (terms, or the carries of the launch
// before) on `stream`: tiles of `threads` x `terms`; carries (2 per tile) to
// cx, cy, cz, cseg. Each returns cudaGetLastError() after the launch.
extern "C" int p2_segment_sums_g1(const void* x, const void* y, const void* z, const void* seg, void* ox, void* oy,
                                  void* oz, void* cx, void* cy, void* cz, void* cseg, int n, int threads, int terms,
                                  void* stream) {
  return launch_level<Fp>(x, y, z, seg, ox, oy, oz, cx, cy, cz, cseg, n, threads, terms, stream);
}

extern "C" int p2_segment_sums_g2(const void* x, const void* y, const void* z, const void* seg, void* ox, void* oy,
                                  void* oz, void* cx, void* cy, void* cz, void* cseg, int n, int threads, int terms,
                                  void* stream) {
  return launch_level<Fp2>(x, y, z, seg, ox, oy, oz, cx, cy, cz, cseg, n, threads, terms, stream);
}
#endif  // __CUDACC__
