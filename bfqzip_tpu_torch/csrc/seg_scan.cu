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
// one segment into the next without a host round trip.  `reverse` scans from
// position n-1 down to 0 (next_marked) with no flipped copies.
//
// Bound: device memory.  The least traffic reads x and the flags once and
// writes out once, (2 * C * sizeof(T) + 1) * n bytes, over 3.35 TB/s.
//
// Design.  The TPU kernel walks its grid in order and threads a carry through
// VMEM; Hopper's blocks run in any order, so:
//   - One block scans one tile (4096 positions of 4-byte T, 2048 of 8-byte T)
//     for all C channels.  It loads the tile's flags once, as 16-byte
//     vectors, into shared memory, then scans the channels in turn.
//   - Loads and stores are 16-byte vectors, neighbouring lanes on
//     neighbouring addresses: a warp covers 32 x 16 contiguous bytes per
//     round.  Each lane reduces its vector's elements, the warp scans the
//     lanes with shuffles, and the rounds chain through the warp's running
//     prefix, so no shared-memory transpose is needed.  The warps' totals
//     are scanned in shared memory.
//   - Integer ops run in ONE pass by decoupled look-back (Merrill & Garland,
//     "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).  A
//     block takes its tile index from an atomic counter, so it never waits on
//     a tile that has not been scheduled.  Each (channel, tile) publishes a
//     status word: not ready, aggregate, or inclusive, with the aggregate's
//     has-flag bit.  int32 packs status, flag and value into one 64-bit word
//     written by one store; int64 writes the value (aggregate and inclusive
//     values in separate slots), then the status with release semantics,
//     and readers load the status with acquire semantics.  A tile whose aggregate holds a flag publishes it as its
//     inclusive value at once (nothing before the flag reaches past it), and
//     a look-back stops at the nearest predecessor that is inclusive or
//     flagged.  One warp inspects 32 predecessors per step.  init[c] is the
//     inclusive value of a virtual tile -1.
//   - float64 add keeps a FIXED summation order: a look-back sums in an order
//     that depends on which predecessors had published, and mode 1 rounds
//     these sums against thresholds, so the result must not change from run
//     to run.  It runs as three launches (tile reduce, one block per channel
//     scanning the tile aggregates, tile scan), with the same tile code.
//   - reverse keeps the tiles on physical addresses and walks them, and
//     the positions inside them, in the opposite order, so a reversed tile
//     has a forward tile's 16-byte alignment.
//   - A row is vector-loaded only where it is 16-byte aligned (row c starts
//     at c * n * sizeof(T)); misaligned rows and the ragged last tile take
//     scalar loads and stores.  Positions past n hold a right identity of
//     combine (combine(v, e) == v) with no flag, so in either direction they
//     leave every real position's result unchanged.
// The scratch (status words, tile counter, or the float64 aggregates and
// carries) is allocated and zeroed by the caller; the kernels allocate
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // 16-byte vectors per thread per channel
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Op { ADD = 0, MAX = 1, OR = 2, KEEPLEFT = 3 };
enum Status : unsigned { NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2 };
enum Mode { SINGLE_PASS = 0, REDUCE = 1, APPLY = 2 };
enum Dtype { I32 = 0, I64 = 1, F64 = 2 };

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);             // elements per vector
  static constexpr int kWarpSpan = 32 * kVec * kRounds;   // positions per warp
  static constexpr int kSize = kWarps * kWarpSpan;        // positions per tile
};

template <typename T>
union Vec {
  uint4 u;
  T v[16 / sizeof(T)];
};

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

// e with combine(v, e) == v for every v: the value of a position past n.
template <typename T, int OP>
__device__ __forceinline__ T right_identity() {
  if constexpr (std::is_floating_point<T>::value) {
    return T(-0.0);  // -0.0 keeps the sign of a -0.0 sum; +0.0 would not
  } else if constexpr (OP == MAX) {
    return sizeof(T) == 4 ? T(INT32_MIN) : T(INT64_MIN);
  } else {
    return T(0);
  }
}

// A prefix that may be empty: (value, has a flag, exists).
template <typename T>
struct Pre {
  T v;
  int f;
  int has;
};

// a precedes b.
template <typename T, int OP>
__device__ __forceinline__ Pre<T> compose(Pre<T> a, Pre<T> b) {
  if (!b.has) return a;
  if (!a.has) return b;
  return Pre<T>{b.f ? b.v : combine<T, OP>(a.v, b.v), a.f | b.f, 1};
}

// (pv, pf) precedes (v, f): v becomes the scan of both.
template <typename T, int OP>
__device__ __forceinline__ void seg_combine(T pv, int pf, T& v, int& f) {
  if (!f) v = combine<T, OP>(pv, v);
  f |= pf;
}

// The value held by the lane d places earlier in scan order (lanes run
// 31 -> 0 in a reverse scan).  Out-of-range sources are read but unused.
template <bool REV, typename T>
__device__ __forceinline__ T shfl_prev(T v, int lane, int d) {
  return __shfl_sync(kFull, v, (REV ? lane + d : lane - d) & 31);
}

template <bool REV>
__device__ __forceinline__ bool has_prev(int lane, int d) {
  return REV ? lane + d < 32 : lane >= d;
}

struct ScanArgs {
  const void* x;
  const uint8_t* flag;
  void* out;
  const void* init;
  int64_t n;
  int64_t ntiles;
  int C;
  unsigned* counter;   // single pass: the next tile index
  void* status;        // single pass: [C * ntiles] status words
  void* values;        // single pass, 8-byte T: [2][C * ntiles] aggregates, inclusive values
  void* agg_v;         // float64: [C * ntiles] tile aggregates
  uint8_t* agg_f;      // float64: [C * ntiles] their flags
  void* carry;         // float64: [C * ntiles] exclusive tile prefixes
};

__device__ __forceinline__ void st_relaxed_b64(void* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_b64(const void* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_b32(void* p, unsigned v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_b32(const void* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// An 8-byte value has one slot per status (aggregate, inclusive), each
// written once: a reader that saw "aggregate" must not read the inclusive
// value that the same tile may publish a moment later.
__device__ __forceinline__ int64_t value_slot(const ScanArgs& a, int64_t i, unsigned status) {
  return status == INCLUSIVE ? (int64_t)a.C * a.ntiles + i : i;
}

template <typename T>
__device__ __forceinline__ void publish(const ScanArgs& a, int64_t i, unsigned status, int f, T v) {
  const unsigned word = status | ((unsigned)f << 2);
  if constexpr (sizeof(T) == 4) {
    st_relaxed_b64((unsigned long long*)a.status + i,
                   ((unsigned long long)word << 32) | (unsigned)v);
  } else {
    st_relaxed_b64((unsigned long long*)a.values + value_slot(a, i, status), (unsigned long long)v);
    st_release_b32((unsigned*)a.status + i, word);
  }
}

template <typename T>
__device__ __forceinline__ void peek(const ScanArgs& a, int64_t i, unsigned& status, int& f, T& v) {
  unsigned word;
  if constexpr (sizeof(T) == 4) {
    const unsigned long long w = ld_relaxed_b64((const unsigned long long*)a.status + i);
    word = (unsigned)(w >> 32);
    v = (T)(unsigned)w;
  } else {
    word = ld_acquire_b32((const unsigned*)a.status + i);
    if ((word & 3) != NOT_READY)
      v = (T)ld_relaxed_b64((const unsigned long long*)a.values + value_slot(a, i, word & 3));
  }
  status = word & 3;
  f = (word >> 2) & 1;
}

// The exclusive prefix of tile t in channel c; run by one whole warp.
template <typename T, int OP>
__device__ T look_back(const ScanArgs& a, int c, int64_t t, int lane) {
  const T init = ((const T*)a.init)[c];
  const int64_t row = (int64_t)c * a.ntiles;
  T excl = init;
  bool have = false;
  for (int64_t base = t - 1;; base -= 32) {
    const int64_t j = base - lane;  // lane 0 is the nearest predecessor
    unsigned status = INCLUSIVE;    // tiles before 0 are the virtual tile -1
    int f = 0;
    T v = init;
    if (j >= 0) peek<T>(a, row + j, status, f, v);
    while (__any_sync(kFull, status == NOT_READY)) {
      if (status == NOT_READY) peek<T>(a, row + j, status, f, v);
    }
    const unsigned stop = __ballot_sync(kFull, status == INCLUSIVE || f);
    const int last = stop ? __ffs(stop) - 1 : 31;
    // combine lanes last .. 0 in scan order (the farther lane first):
    // after step d, lane i holds lanes [i, min(i + 2d, last + 1))
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T o = __shfl_down_sync(kFull, v, d);
      if (lane + d <= last) v = combine<T, OP>(o, v);
    }
    const T w = __shfl_sync(kFull, v, 0);
    excl = have ? combine<T, OP>(w, excl) : w;
    have = true;
    if (stop) return excl;
  }
}

template <typename T, int OP, bool REV, int MODE>
__global__ void __launch_bounds__(kThreads) scan_tiles(const ScanArgs a) {
  constexpr int V = Tile<T>::kVec;
  __shared__ __align__(16) uint8_t sflag[Tile<T>::kSize];
  __shared__ T swv[kWarps];
  __shared__ int swf[kWarps];
  __shared__ T sxv[kWarps];
  __shared__ int sxf[kWarps];
  __shared__ T sprefix;
  __shared__ unsigned stile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lwarp = REV ? kWarps - 1 - warp : warp;  // the warp's place in scan order

  int64_t t;  // the tile's place in scan order
  if constexpr (MODE == SINGLE_PASS) {
    if (threadIdx.x == 0) stile = atomicAdd(a.counter, 1u);
    __syncthreads();
    t = stile;
  } else {
    t = blockIdx.x;
  }
  const int64_t p = REV ? a.ntiles - 1 - t : t;  // its place in memory
  const int64_t base = p * Tile<T>::kSize;
  const int64_t n = a.n;
  const bool full = base + Tile<T>::kSize <= n;

  // the tile's flags, once for all channels; none past n
  if (full && ((uintptr_t)(a.flag + base) & 15) == 0) {
    for (int i = threadIdx.x; i < Tile<T>::kSize / 16; i += kThreads)
      reinterpret_cast<uint4*>(sflag)[i] = reinterpret_cast<const uint4*>(a.flag + base)[i];
  } else {
    for (int i = threadIdx.x; i < Tile<T>::kSize; i += kThreads)
      sflag[i] = base + i < n ? a.flag[base + i] : 0;
  }
  __syncthreads();

  // this thread's element j of round r sits at off0 + r * 32 * V + j
  const int off0 = warp * Tile<T>::kWarpSpan + lane * V;

  for (int c = 0; c < a.C; ++c) {
    const T* xc = (const T*)a.x + (int64_t)c * n + base;
    T* oc = (T*)a.out + (int64_t)c * n + base;
    const bool vec = full && (((uintptr_t)xc | (uintptr_t)oc) & 15) == 0;

    T xv[kRounds][V];
    unsigned xf[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int off = off0 + r * 32 * V;
      if (vec) {
        Vec<T> u;
        u.u = *reinterpret_cast<const uint4*>(xc + off);
#pragma unroll
        for (int j = 0; j < V; ++j) xv[r][j] = u.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          xv[r][j] = base + off + j < n ? xc[off + j] : right_identity<T, OP>();
      }
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) m |= (unsigned)(sflag[off + j] != 0) << j;
      xf[r] = m;
    }

    // per round: the lane's elements, then the warp's lanes, in scan order;
    // lane_pre[r] is what precedes the lane's first element within the warp
    Pre<T> lane_pre[kRounds];
    Pre<T> run = {T(0), 0, 0};
#pragma unroll
    for (int rr = 0; rr < kRounds; ++rr) {
      const int r = REV ? kRounds - 1 - rr : rr;
      T v = T(0);
      int f = 0;
#pragma unroll
      for (int jj = 0; jj < V; ++jj) {
        const int j = REV ? V - 1 - jj : jj;
        const int fj = (xf[r] >> j) & 1;
        v = (jj == 0 || fj) ? xv[r][j] : combine<T, OP>(v, xv[r][j]);
        f |= fj;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const T ov = shfl_prev<REV>(v, lane, d);
        const int of = shfl_prev<REV>(f, lane, d);
        if (has_prev<REV>(lane, d)) seg_combine<T, OP>(ov, of, v, f);
      }
      const T ev = shfl_prev<REV>(v, lane, 1);
      const int ef = shfl_prev<REV>(f, lane, 1);
      lane_pre[r] = compose<T, OP>(run, Pre<T>{ev, ef, has_prev<REV>(lane, 1)});
      const int tail = REV ? 0 : 31;
      run = compose<T, OP>(run, Pre<T>{__shfl_sync(kFull, v, tail), __shfl_sync(kFull, f, tail), 1});
    }

    // the warps' totals, scanned in scan order by warp 0
    if (lane == 0) {
      swv[lwarp] = run.v;
      swf[lwarp] = run.f;
    }
    __syncthreads();
    if (warp == 0) {
      T v = lane < kWarps ? swv[lane] : T(0);
      int f = lane < kWarps ? swf[lane] : 0;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const T ov = __shfl_up_sync(kFull, v, d);
        const int of = __shfl_up_sync(kFull, f, d);
        if (lane >= d) seg_combine<T, OP>(ov, of, v, f);
      }
      const T ev = __shfl_up_sync(kFull, v, 1);
      const int ef = __shfl_up_sync(kFull, f, 1);
      if (lane < kWarps) {
        sxv[lane] = ev;
        sxf[lane] = ef;
      }
      const T agg = __shfl_sync(kFull, v, kWarps - 1);
      const int aggf = __shfl_sync(kFull, f, kWarps - 1);
      const int64_t idx = (int64_t)c * a.ntiles + t;
      if constexpr (MODE == SINGLE_PASS) {
        if (lane == 0) publish<T>(a, idx, aggf ? INCLUSIVE : AGGREGATE, aggf, agg);
        const T P = look_back<T, OP>(a, c, t, lane);
        if (lane == 0) {
          if (!aggf) publish<T>(a, idx, INCLUSIVE, 0, combine<T, OP>(P, agg));
          sprefix = P;
        }
      } else if constexpr (MODE == REDUCE) {
        if (lane == 0) {
          ((T*)a.agg_v)[idx] = agg;
          a.agg_f[idx] = (uint8_t)aggf;
        }
      } else {
        if (lane == 0) sprefix = ((const T*)a.carry)[idx];
      }
    }
    __syncthreads();
    if constexpr (MODE == REDUCE) continue;

    const T P = sprefix;
    const Pre<T> wp = {sxv[lwarp], sxf[lwarp], lwarp > 0};
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const Pre<T> lp = compose<T, OP>(wp, lane_pre[r]);
      T acc = lp.has ? (lp.f ? lp.v : combine<T, OP>(P, lp.v)) : P;
      Vec<T> u;
#pragma unroll
      for (int jj = 0; jj < V; ++jj) {
        const int j = REV ? V - 1 - jj : jj;
        acc = ((xf[r] >> j) & 1) ? xv[r][j] : combine<T, OP>(acc, xv[r][j]);
        u.v[j] = acc;
      }
      const int off = off0 + r * 32 * V;
      if (vec) {
        *reinterpret_cast<uint4*>(oc + off) = u.u;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (base + off + j < n) oc[off + j] = u.v[j];
      }
    }
  }
}

// Inclusive segmented scan of one (v, f) per thread across the block.
// On return sv[NT/32 - 1], sf[NT/32 - 1] hold the block total, and
// sv[w], sf[w] the inclusive total through warp w.
template <typename T, int OP, int NT>
__device__ __forceinline__ void block_scan(T& v, int& f, T* sv, int* sf) {
  constexpr int kW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T ov = __shfl_up_sync(kFull, v, d);
    int of = __shfl_up_sync(kFull, f, d);
    if (lane >= d) seg_combine<T, OP>(ov, of, v, f);
  }
  if (lane == 31) {
    sv[warp] = v;
    sf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    T wv = lane < kW ? sv[lane] : T(0);
    int wf = lane < kW ? sf[lane] : 1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T ov = __shfl_up_sync(kFull, wv, d);
      int of = __shfl_up_sync(kFull, wf, d);
      if (lane >= d) seg_combine<T, OP>(ov, of, wv, wf);
    }
    if (lane < kW) {
      sv[lane] = wv;
      sf[lane] = wf;
    }
  }
  __syncthreads();
  if (warp > 0) seg_combine<T, OP>(sv[warp - 1], sf[warp - 1], v, f);
}

// float64 pass 2: one block per channel scans the tile aggregates, in scan
// order, into each tile's exclusive prefix (init before tile 0).
template <typename T, int OP>
__global__ void __launch_bounds__(kCarryThreads) tile_carry(const ScanArgs a) {
  __shared__ T sv[kCarryThreads / 32];
  __shared__ int sf[kCarryThreads / 32];
  const int64_t c = blockIdx.x;
  const T* agg_v = (const T*)a.agg_v + c * a.ntiles;
  const uint8_t* agg_f = a.agg_f + c * a.ntiles;
  T* carry = (T*)a.carry + c * a.ntiles;
  T run = ((const T*)a.init)[c];  // the scan of every tile before this chunk
  for (int64_t chunk = 0; chunk < a.ntiles; chunk += kCarryThreads) {
    const int64_t t = chunk + threadIdx.x;
    T v = T(0);
    int f = 1;
    if (t < a.ntiles) {
      v = agg_v[t];
      f = agg_f[t];
    }
    block_scan<T, OP, kCarryThreads>(v, f, sv, sf);
    // the inclusive value of the previous thread, or nothing for thread 0
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T ev = __shfl_up_sync(kFull, v, 1);
    int ef = __shfl_up_sync(kFull, f, 1);
    int has = 1;
    if (lane == 0) {
      if (warp > 0) {
        ev = sv[warp - 1];
        ef = sf[warp - 1];
      } else {
        has = 0;
      }
    }
    if (t < a.ntiles) carry[t] = has ? (ef ? ev : combine<T, OP>(run, ev)) : run;
    const T tv = sv[kCarryThreads / 32 - 1];
    const int tf = sf[kCarryThreads / 32 - 1];
    run = tf ? tv : combine<T, OP>(run, tv);
    __syncthreads();  // sv/sf are rewritten by the next chunk
  }
}

template <typename T, int OP, bool REV>
int launch_single_pass(const ScanArgs& a, cudaStream_t s) {
  scan_tiles<T, OP, REV, SINGLE_PASS><<<(unsigned)a.ntiles, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool REV>
int launch_f64(const ScanArgs& a, cudaStream_t s) {
  cudaError_t err;
  scan_tiles<double, ADD, REV, REDUCE><<<(unsigned)a.ntiles, kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_carry<double, ADD><<<a.C, kCarryThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_tiles<double, ADD, REV, APPLY><<<(unsigned)a.ntiles, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool REV>
int launch_int(int op, const ScanArgs& a, cudaStream_t s) {
  switch (op) {
    case ADD:
      return launch_single_pass<T, ADD, REV>(a, s);
    case MAX:
      return launch_single_pass<T, MAX, REV>(a, s);
    case OR:
      return launch_single_pass<T, OR, REV>(a, s);
    case KEEPLEFT:
      return launch_single_pass<T, KEEPLEFT, REV>(a, s);
    default:
      return -1;
  }
}

int tile_size(int dtype) { return dtype == I32 ? Tile<int32_t>::kSize : Tile<int64_t>::kSize; }

int64_t round16(int64_t b) { return (b + 15) & ~int64_t(15); }

// The scratch layout of one launch inside one zeroed buffer; returns its size.
int64_t layout(int dtype, int64_t n, int C, char* scratch, ScanArgs* a) {
  const int64_t cells = (int64_t)C * ((n + tile_size(dtype) - 1) / tile_size(dtype));
  int64_t at = 0;
  auto take = [&](int64_t bytes) {
    char* p = scratch ? scratch + at : nullptr;
    at += round16(bytes);
    return p;
  };
  if (dtype == F64) {
    char* agg_v = take(cells * 8);
    char* carry = take(cells * 8);
    char* agg_f = take(cells);
    if (a) {
      a->agg_v = agg_v;
      a->carry = carry;
      a->agg_f = (uint8_t*)agg_f;
    }
  } else {
    char* counter = take(sizeof(unsigned));
    char* status = take(cells * (dtype == I32 ? 8 : 4));
    char* values = dtype == I64 ? take(2 * cells * 8) : nullptr;
    if (a) {
      a->counter = (unsigned*)counter;
      a->status = status;
      a->values = values;
    }
  }
  return at;
}

}  // namespace

extern "C" {

// dtype: 0 int32, 1 int64, 2 float64.  Positions per tile.
int bfq_seg_scan_tile(int dtype) { return tile_size(dtype); }

// Bytes of zeroed scratch one launch of bfq_seg_scan needs.
long long bfq_seg_scan_scratch_bytes(int dtype, long long n, int C) {
  return layout(dtype, n, C, nullptr, nullptr);
}

// x, out: [C, n] of the dtype; flag: [n] uint8; init: [C] of the dtype;
// scratch: bfq_seg_scan_scratch_bytes(dtype, n, C) bytes, zeroed, 16-byte
// aligned.  op: 0 add, 1 max, 2 or, 3 keepleft (float64: add only).
// Launches on `stream` and returns a cudaError_t (0 on success, -1 for an
// unsupported dtype/op pair).
int bfq_seg_scan(int dtype, const void* x, const void* flag, void* out, void* scratch,
                 const void* init, long long n, int C, int op, int reverse, void* stream) {
  if (n <= 0 || C <= 0) return 0;
  ScanArgs a = {};
  a.x = x;
  a.flag = (const uint8_t*)flag;
  a.out = out;
  a.init = init;
  a.n = n;
  a.ntiles = (n + tile_size(dtype) - 1) / tile_size(dtype);
  a.C = C;
  layout(dtype, n, C, (char*)scratch, &a);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case I32:
      return reverse ? launch_int<int32_t, true>(op, a, s) : launch_int<int32_t, false>(op, a, s);
    case I64:
      return reverse ? launch_int<long long, true>(op, a, s) : launch_int<long long, false>(op, a, s);
    case F64:
      if (op != ADD) return -1;
      return reverse ? launch_f64<true>(a, s) : launch_f64<false>(a, s);
    default:
      return -1;
  }
}

}  // extern "C"
