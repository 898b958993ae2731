// Ring-hop local accumulate for Hopper (sm_90a): out = cast(a) + cast(b).
//
// Replaces the Pallas TPU kernel `add_accum_2d` (body `_kernel`) in
// src/repro/kernels/reduce_add/reduce_add.py.  Every reduce-scatter hop of
// the ring (src/repro_torch/core/ring.py) adds the payload it received from
// its neighbour (a: the wire dtype, fp32 or bf16) to its own slice of the
// bucket (b: fp32) in fp32, and writes the fp32 partial sum (or a narrow
// bf16 copy of it).  The sum is one IEEE fp32 add per element (__fadd_rn,
// never contracted), the same one the plain version does, so the two agree
// bit for bit.
//
// What bounds it: memory.  No value is reused: per element it reads a and
// b and writes out once, 12 bytes at an fp32 wire, so the least time is
// bytes / 3.35 TB/s.  What reaches that rate is a memory front that moves
// through the three arrays in address order with many loads in flight:
//
//  * One contiguous tile per block, in address order, with no cap on the
//    grid and no grid-stride loop: the block scheduler hands tiles out
//    front to back.  (A persistent grid lets its blocks drift apart and
//    spreads the front: 0.86-0.88 of the bound against 0.91 on an H100,
//    PERF.md's reduce_add A/B.)
//  * A tile is kThreads x kUnroll vectors.  A vector is V consecutive
//    elements, V = 4 when all three arrays are fp32 and 8 when any is bf16,
//    so every access is one or two 16-byte loads or stores (a bf16 operand
//    reads 8 elements per 16-byte load).  A thread issues all its loads,
//    kUnroll vectors of each operand, before its first add; a warp's lanes
//    take neighbouring vectors of each load.
//  * Streaming cache hints (__ldcs / __stcs): nothing is reused.
//
// Any length and any start run through the kernel.  The host finds the
// first element h < 8 at which all three pointers sit on 16-byte
// boundaries; elements before it (head) and after the last whole vector
// (tail), fewer than 8 on each side, are added one by one by block 0.
// When no such h exists (the three starts are not congruent), the whole
// range is added element by element on the same tile grid.  (The TPU
// wrapper sends lengths that do not tile (8, 128) to its oracle; this kernel
// has no such branch.)
//
// Types: a, b and out each float32 or bfloat16 (codes 0 and 1); the
// accumulation is always fp32.  Rounding to bf16 is round-to-nearest-even,
// as torch's `.to(torch.bfloat16)`.
//
// C interface (bound with ctypes): `reduce_add` launches once on the given
// stream and returns cudaGetLastError(); a bad argument returns
// cudaErrorInvalidValue without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The tile's shape, picked on an H100 (PERF.md, the reduce_add A/B): 128 to
// 512 threads with 1 to 8 vectors each came within 1 % of one another at the
// train path's largest hop.
constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // vectors in flight per operand and thread
constexpr long long kTile = (long long)kThreads * kUnroll;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements of T in 16-byte words (V * sizeof(T) a multiple of
// 16), or one element when V == 1.
template <typename T, int V> struct Pack {
  static constexpr int W = V * (int)sizeof(T) / 16;
  uint4 w[W];
  __device__ __forceinline__ void load(const T* p) {
    const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = __ldcs(s + i);
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4* d = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < W; ++i) __stcs(d + i, w[i]);
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f(reinterpret_cast<const T*>(w)[i]);
  }
  __device__ __forceinline__ void set(int i, float x) {
    reinterpret_cast<T*>(w)[i] = from_f<T>(x);
  }
};

template <typename T> struct Pack<T, 1> {
  T x;
  __device__ __forceinline__ void load(const T* p) { x = *p; }
  __device__ __forceinline__ void store(T* p) const { *p = x; }
  __device__ __forceinline__ float get(int) const { return to_f(x); }
  __device__ __forceinline__ void set(int, float y) { x = from_f<T>(y); }
};

// out[e] = a[e] + b[e] for the nv vectors of V elements from element
// `head` (a tile of kTile vectors per block), and, on block 0, the head
// and tail elements one by one.
template <typename A, typename B, typename O, int V>
__global__ void __launch_bounds__(kThreads)
reduce_add_kernel(const A* __restrict__ a, const B* __restrict__ b,
                  O* __restrict__ out, long long n, long long head,
                  long long nv) {
  const long long first = (long long)blockIdx.x * kTile + threadIdx.x;
  const A* a0 = a + head;
  const B* b0 = b + head;
  O* o0 = out + head;
  Pack<A, V> xa[kUnroll];
  Pack<B, V> xb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = first + u * kThreads;
    if (i < nv) {
      xa[u].load(a0 + i * V);
      xb[u].load(b0 + i * V);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = first + u * kThreads;
    if (i < nv) {
      Pack<O, V> y;
#pragma unroll
      for (int k = 0; k < V; ++k)
        y.set(k, __fadd_rn(xa[u].get(k), xb[u].get(k)));
      y.store(o0 + i * V);
    }
  }
  if (blockIdx.x == 0) {            // fewer than 8 elements on each side
    const int t = threadIdx.x;
    const long long tail = head + nv * V;
    long long e = -1;
    if (t < head) e = t;
    else if (t >= 8 && tail + (t - 8) < n) e = tail + (t - 8);
    if (e >= 0) out[e] = from_f<O>(__fadd_rn(to_f(a[e]), to_f(b[e])));
  }
}

template <typename A, typename B, typename O, int V>
int launch_v(const A* a, const B* b, O* out, long long n, long long head,
             long long nv, cudaStream_t stream) {
  long long blocks = (nv + kTile - 1) / kTile;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  reduce_add_kernel<A, B, O, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, b, out, n, head, nv);
  return (int)cudaGetLastError();
}

template <typename A, typename B, typename O>
int launch(const void* a_, const void* b_, void* out_, long long n,
           cudaStream_t stream) {
  const A* a = static_cast<const A*>(a_);
  const B* b = static_cast<const B*>(b_);
  O* out = static_cast<O*>(out_);
  constexpr int V = (sizeof(A) == 2 || sizeof(B) == 2 || sizeof(O) == 2) ? 8
                                                                        : 4;
  const auto on16 = [](const void* p, long long e, size_t size) {
    return (reinterpret_cast<uintptr_t>(p) + e * size) % 16 == 0;
  };
  long long head = -1;
  for (long long h = 0; h < 8 && head < 0; ++h)
    if (on16(a, h, sizeof(A)) && on16(b, h, sizeof(B)) &&
        on16(out, h, sizeof(O)))
      head = h;
  if (head < 0 || n < head + V)     // not congruent, or no whole vector
    return launch_v<A, B, O, 1>(a, b, out, n, 0, n, stream);
  return launch_v<A, B, O, V>(a, b, out, n, head, (n - head) / V, stream);
}

template <typename A, typename B>
int launch_o(int o_dt, const void* a, const void* b, void* out, long long n,
             cudaStream_t s) {
  return o_dt ? launch<A, B, bf16>(a, b, out, n, s)
              : launch<A, B, float>(a, b, out, n, s);
}

}  // namespace

// a, b, out: n contiguous elements each; a_dt / b_dt / o_dt: 0 float32,
// 1 bfloat16.  Returns a cudaError_t.
extern "C" int reduce_add(const void* a, const void* b, void* out,
                          long long n, int a_dt, int b_dt, int o_dt,
                          void* stream) {
  if (n < 1 || a_dt < 0 || a_dt > 1 || b_dt < 0 || b_dt > 1 || o_dt < 0 ||
      o_dt > 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dt && b_dt) return launch_o<bf16, bf16>(o_dt, a, b, out, n, s);
  if (a_dt) return launch_o<bf16, float>(o_dt, a, b, out, n, s);
  if (b_dt) return launch_o<float, bf16>(o_dt, a, b, out, n, s);
  return launch_o<float, float>(o_dt, a, b, out, n, s);
}
