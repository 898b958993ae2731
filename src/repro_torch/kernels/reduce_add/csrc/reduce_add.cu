// Ring-hop local accumulate for Hopper (sm_90a): out = cast(a) + cast(b).
//
// Replaces the Pallas TPU kernel `add_accum_2d` (body `_kernel`) in
// src/repro/kernels/reduce_add/reduce_add.py.  Every reduce-scatter hop of
// the ring (src/repro_torch/core/ring.py) adds the payload it received from
// its neighbour (a: the wire dtype, fp32 or bf16) to its own slice of the
// bucket (b: fp32) in fp32, and writes the fp32 partial sum (or a narrow
// bf16 copy of it).  The sum is one IEEE fp32 add per element, the same one
// the plain version does, so the two agree bit for bit.
//
// What bounds it: memory.  No value is reused: per element it reads a and
// b and writes out once, 12 bytes at an fp32 wire and 0 useful flops of
// reuse, so the least time is bytes / 3.35 TB/s.  The design only has to
// stream: a grid-stride loop in which each thread moves 4 consecutive
// elements per iteration with one vector load per operand (16 bytes for
// fp32, 8 for bf16) when all three pointers are aligned to 4 elements, and
// element by element otherwise.  Any length runs through the kernel: the
// last n % 4 elements are a scalar tail.  (The TPU wrapper sends lengths
// that do not tile (8, 128) to its oracle; this kernel has no such branch.)
//
// Types: a, b and out each float32 or bfloat16 (codes 0 and 1); the
// accumulation is always fp32.  Rounding to bf16 is round-to-nearest-even,
// as torch's `.to(torch.bfloat16)`.
//
// C interface (bound with ctypes): `reduce_add` launches on the given stream
// and returns cudaGetLastError(); a bad argument returns
// cudaErrorInvalidValue without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 resident blocks on each of 132 SMs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// 4 consecutive elements in one vector access.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const T* h = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = to_f(h[k]);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint2 x;
    T* h = reinterpret_cast<T*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint2*>(p) = x;
  }
}

template <typename A, typename B, typename O>
__global__ void __launch_bounds__(kThreads)
reduce_add_kernel(const A* __restrict__ a, const B* __restrict__ b,
                  O* __restrict__ out, long long n, int vectorised) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorised) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float va[4], vb[4], vo[4];
      load4(a + 4 * i, va);
      load4(b + 4 * i, vb);
#pragma unroll
      for (int k = 0; k < 4; ++k) vo[k] = va[k] + vb[k];
      store4(out + 4 * i, vo);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = from_f<O>(to_f(a[i]) + to_f(b[i]));
}

template <typename A, typename B, typename O>
int launch(const void* a, const void* b, void* out, long long n,
           cudaStream_t stream) {
  const auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int vec = aligned(a, 4 * sizeof(A)) && aligned(b, 4 * sizeof(B)) &&
                  aligned(out, 4 * sizeof(O));
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  reduce_add_kernel<A, B, O><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const A*>(a), static_cast<const B*>(b),
      static_cast<O*>(out), n, vec);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

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
