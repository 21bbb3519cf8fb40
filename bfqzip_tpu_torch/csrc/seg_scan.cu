// Inclusive segmented scan on Hopper (sm_90a).
//
// Replaces the TPU kernel bfqzip_tpu/ops/pallas_scan.py::_seg_scan_kernel
// (launched by _seg_scan_1p).  Semantics, for each channel c of x[C, n] and
// one flag row shared by all channels:
//
//     out[i] = x[i]                     if flag[i]
//              combine(out[i-1], x[i])  otherwise,   out[-1] = init[c]
//
// with combine in {add, max, or, keepleft (combine(a, b) = a)} on int32 and
// int64, and add on float64.  `init` is a device array of one value per
// channel, so a streaming caller carries each channel's boundary value from
// one segment into the next without a host round trip (for these ops,
// scan(x, init = carry) == combine(carry, scan(x, init = identity)) before the
// first flag).  `reverse` maps logical index j to n-1-j, so a right-to-left
// scan (next_marked) needs no flipped copies.
//
// Design: the TPU kernel walks its grid in order and threads a carry through
// VMEM scratch.  Blocks on Hopper run in any order, so this is a
// deterministic reduce-then-scan in three launches:
//   K1 tile_reduce: grid (tiles, C); each block reduces a 4096-position tile
//      to its segmented aggregate (value, has_flag).
//   K2 tile_carry:  one block per channel scans the tile aggregates into the
//      exclusive carry-in of every tile.
//   K3 tile_scan:   each block re-scans its tile (per-thread sequential scan,
//      warp __shfl_up_sync scan of (value, flag) pairs, cross-warp pass in
//      shared memory), applies the carry-in and writes the output.
// Every position gets a defined carry-in (init before the first tile), so no
// op needs an identity element; keepleft, which has none, works unchanged.
//
// Bound: device memory.  Per channel, x is read twice (K1, K3) and out
// written once, 3 x 4 B/elem for int32 (3 x 8 B for int64 and float64), plus 1 B/elem
// of flags per read pass; K2 touches only tiles/4096 of that.  A single-pass
// decoupled look-back scan would cut the traffic to 2 passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // positions per K1/K3 block
constexpr int kCarryThreads = 1024;

enum Op { ADD = 0, MAX = 1, OR = 2, KEEPLEFT = 3 };

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == ADD) {
    return a + b;
  } else if constexpr (OP == MAX) {
    return a > b ? a : b;
  } else if constexpr (OP == OR) {
    return a | b;
  } else {
    return a;
  }
}

// (pv, pf) precedes (v, f): v becomes the scan of both.
template <typename T, int OP>
__device__ __forceinline__ void seg_combine(T pv, int pf, T& v, int& f) {
  if (!f) v = combine<T, OP>(pv, v);
  f |= pf;
}

// Inclusive segmented scan of one (v, f) per thread across the block.
// On return sv[NT/32 - 1], sf[NT/32 - 1] hold the block total, and
// sv[w], sf[w] the inclusive total through warp w.
template <typename T, int OP, int NT>
__device__ __forceinline__ void block_scan(T& v, int& f, T* sv, int* sf) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T ov = __shfl_up_sync(0xffffffffu, v, d);
    int of = __shfl_up_sync(0xffffffffu, f, d);
    if (lane >= d) seg_combine<T, OP>(ov, of, v, f);
  }
  if (lane == 31) {
    sv[warp] = v;
    sf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    T wv = lane < kWarps ? sv[lane] : T(0);
    int wf = lane < kWarps ? sf[lane] : 1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T ov = __shfl_up_sync(0xffffffffu, wv, d);
      int of = __shfl_up_sync(0xffffffffu, wf, d);
      if (lane >= d) seg_combine<T, OP>(ov, of, wv, wf);
    }
    if (lane < kWarps) {
      sv[lane] = wv;
      sf[lane] = wf;
    }
  }
  __syncthreads();
  if (warp > 0) seg_combine<T, OP>(sv[warp - 1], sf[warp - 1], v, f);
}

// The inclusive value of the previous thread after block_scan; has = 0 for
// thread 0.
template <typename T>
__device__ __forceinline__ void block_exclusive(T v, int f, const T* sv, const int* sf,
                                                T& ev, int& ef, int& has) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ev = __shfl_up_sync(0xffffffffu, v, 1);
  ef = __shfl_up_sync(0xffffffffu, f, 1);
  has = 1;
  if (lane == 0) {
    if (warp > 0) {
      ev = sv[warp - 1];
      ef = sf[warp - 1];
    } else {
      has = 0;
    }
  }
}

// Loads this thread's kItems consecutive logical positions.  Positions past
// n are flagged, so they never reach a real position.
template <typename T>
__device__ __forceinline__ void load_items(const T* xc, const uint8_t* flag, int64_t n,
                                           int64_t j0, int reverse, T (&xv)[kItems],
                                           int (&xf)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = j0 + i;
    if (j < n) {
      const int64_t p = reverse ? n - 1 - j : j;
      xv[i] = xc[p];
      xf[i] = flag[p] != 0;
    } else {
      xv[i] = T(0);
      xf[i] = 1;
    }
  }
}

template <typename T, int OP>
__device__ __forceinline__ void reduce_items(const T (&xv)[kItems], const int (&xf)[kItems],
                                             T& v, int& f) {
  v = xv[0];
  f = xf[0];
#pragma unroll
  for (int i = 1; i < kItems; ++i) {
    v = xf[i] ? xv[i] : combine<T, OP>(v, xv[i]);
    f |= xf[i];
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(const T* __restrict__ x, const uint8_t* __restrict__ flag, T* __restrict__ agg_v,
                uint8_t* __restrict__ agg_f, int64_t n, int reverse) {
  __shared__ T sv[kThreads / 32];
  __shared__ int sf[kThreads / 32];
  const int64_t tile = blockIdx.x;
  const int64_t ntiles = gridDim.x;
  const int c = blockIdx.y;
  T xv[kItems];
  int xf[kItems];
  load_items<T>(x + c * n, flag, n, tile * kTile + threadIdx.x * kItems, reverse, xv, xf);
  T v;
  int f;
  reduce_items<T, OP>(xv, xf, v, f);
  block_scan<T, OP, kThreads>(v, f, sv, sf);
  if (threadIdx.x == kThreads - 1) {
    agg_v[c * ntiles + tile] = v;
    agg_f[c * ntiles + tile] = (uint8_t)f;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kCarryThreads)
    tile_carry(const T* __restrict__ agg_v, const uint8_t* __restrict__ agg_f,
               T* __restrict__ carry, int64_t ntiles, const T* __restrict__ init) {
  __shared__ T sv[kCarryThreads / 32];
  __shared__ int sf[kCarryThreads / 32];
  const int64_t c = blockIdx.x;
  T run = init[c];  // scan of every tile before this chunk
  for (int64_t base = 0; base < ntiles; base += kCarryThreads) {
    const int64_t t = base + threadIdx.x;
    T v = T(0);
    int f = 1;
    if (t < ntiles) {
      v = agg_v[c * ntiles + t];
      f = agg_f[c * ntiles + t];
    }
    block_scan<T, OP, kCarryThreads>(v, f, sv, sf);
    T ev;
    int ef, has;
    block_exclusive<T>(v, f, sv, sf, ev, ef, has);
    if (t < ntiles) carry[c * ntiles + t] = has ? (ef ? ev : combine<T, OP>(run, ev)) : run;
    const T tv = sv[kCarryThreads / 32 - 1];
    const int tf = sf[kCarryThreads / 32 - 1];
    run = tf ? tv : combine<T, OP>(run, tv);
    __syncthreads();  // sv/sf are rewritten by the next chunk
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    tile_scan(const T* __restrict__ x, const uint8_t* __restrict__ flag,
              const T* __restrict__ carry, T* __restrict__ out, int64_t n, int reverse) {
  __shared__ T sv[kThreads / 32];
  __shared__ int sf[kThreads / 32];
  const int64_t tile = blockIdx.x;
  const int64_t ntiles = gridDim.x;
  const int c = blockIdx.y;
  const int64_t j0 = tile * kTile + threadIdx.x * kItems;
  T xv[kItems];
  int xf[kItems];
  load_items<T>(x + c * n, flag, n, j0, reverse, xv, xf);
  T v;
  int f;
  reduce_items<T, OP>(xv, xf, v, f);
  block_scan<T, OP, kThreads>(v, f, sv, sf);
  T ev;
  int ef, has;
  block_exclusive<T>(v, f, sv, sf, ev, ef, has);
  const T cin = carry[c * ntiles + tile];
  T run = has ? (ef ? ev : combine<T, OP>(cin, ev)) : cin;
  T* oc = out + c * n;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = j0 + i;
    run = xf[i] ? xv[i] : combine<T, OP>(run, xv[i]);
    if (j < n) oc[reverse ? n - 1 - j : j] = run;
  }
}

template <typename T, int OP>
int launch(const void* x, const void* flag, void* out, void* agg_v, void* agg_f, void* carry,
           const void* init, int64_t n, int C, int reverse, cudaStream_t stream) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)ntiles, (unsigned)C);
  cudaError_t err;
  tile_reduce<T, OP><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const uint8_t*)flag, (T*)agg_v, (uint8_t*)agg_f, n, reverse);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_carry<T, OP><<<C, kCarryThreads, 0, stream>>>(
      (const T*)agg_v, (const uint8_t*)agg_f, (T*)carry, ntiles, (const T*)init);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_scan<T, OP><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const uint8_t*)flag, (const T*)carry, (T*)out, n, reverse);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const void* x, const void* flag, void* out, void* agg_v, void* agg_f,
              void* carry, const void* init, int64_t n, int C, int reverse, cudaStream_t s) {
  switch (op) {
    case ADD:
      return launch<T, ADD>(x, flag, out, agg_v, agg_f, carry, init, n, C, reverse, s);
    case MAX:
      return launch<T, MAX>(x, flag, out, agg_v, agg_f, carry, init, n, C, reverse, s);
    case OR:
      return launch<T, OR>(x, flag, out, agg_v, agg_f, carry, init, n, C, reverse, s);
    case KEEPLEFT:
      return launch<T, KEEPLEFT>(x, flag, out, agg_v, agg_f, carry, init, n, C, reverse, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Positions per tile; the caller sizes agg_v, agg_f and carry as
// C * ceil(n / tile) elements.
int bfq_seg_scan_tile(void) { return kTile; }

// x, out: [C, n]; flag: [n] uint8; init: [C]; agg_v, carry: [C * tiles];
// agg_f: [C * tiles] uint8.  x, out, init, agg_v and carry share the entry
// point's type.  op: 0 add, 1 max, 2 or, 3 keepleft.
// Returns a cudaError_t (0 on success, -1 for an unknown op).
int bfq_seg_scan_i32(const void* x, const void* flag, void* out, void* agg_v, void* agg_f,
                     void* carry, const void* init, long long n, int C, int op, int reverse,
                     void* stream) {
  return launch_op<int32_t>(op, x, flag, out, agg_v, agg_f, carry, init, n, C, reverse,
                            (cudaStream_t)stream);
}

// int64: the out-of-core path's segment coordinates beyond 2^31 positions.
int bfq_seg_scan_i64(const void* x, const void* flag, void* out, void* agg_v, void* agg_f,
                     void* carry, const void* init, long long n, int C, int op, int reverse,
                     void* stream) {
  return launch_op<long long>(op, x, flag, out, agg_v, agg_f, carry, init, n, C, reverse,
                              (cudaStream_t)stream);
}

// float64 add only (the mode-1 error sums).
int bfq_seg_scan_f64(const void* x, const void* flag, void* out, void* agg_v, void* agg_f,
                     void* carry, const void* init, long long n, int C, int reverse,
                     void* stream) {
  return launch<double, ADD>(x, flag, out, agg_v, agg_f, carry, init, n, C, reverse,
                             (cudaStream_t)stream);
}

}  // extern "C"
