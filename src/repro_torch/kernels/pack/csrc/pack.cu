// Arena pack and unpack copies for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/pack/pack.py:
//
//  * `write_rows_2d` (body `_copy_kernel`): writes one gradient bucket into
//    its segment of the communication arena, in place, cast to the arena's
//    dtype -> `pack_write` here, kernel `write_flat_kernel`;
//  * `read_rows_2d` (body `_slice_kernel`): copies one segment back out of
//    the arena into a fresh buffer -> `pack_read`, kernel `read_flat_kernel`.
//
// The arena (src/repro_torch/mem/arena.py) is one tensor allocated once and
// written in place every step, the port's form of the reference's donated,
// page-aligned buffer.  Both copies are exact: a same-type copy moves bits,
// and the only cast, fp32 -> bf16, rounds to nearest even as torch's
// `.to(torch.bfloat16)` does, so each equals its plain version bit for bit.
//
// What bounds them: memory.  Each element is read once and written once
// (8 bytes per fp32 element), no flops, so the least time is
// bytes / 3.35 TB/s.  The design streams with a grid-stride loop moving 4
// consecutive elements per thread per iteration in one vector access each
// way (16 bytes for fp32, 8 for bf16) when both pointers are aligned to 4
// elements, element by element otherwise.  Any offset and any size run
// through the kernel: an odd offset only loses the vector path, and the
// last size % 4 elements are a scalar tail.  (The TPU wrappers send copies
// that do not tile (8, 128), and casts, to their oracle; these kernels have
// no such branch.)  One launch per segment, like the reference; a grouped
// copy of every bucket in one launch is later work.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError(); a bad argument returns
// cudaErrorInvalidValue without launching.  Type codes: 0 float32,
// 1 bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 resident blocks on each of 132 SMs

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename D, typename S> __device__ __forceinline__ D cast(S x);
template <> __device__ __forceinline__ float cast<float, float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 cast<bf16, bf16>(bf16 x) {
  return x;
}
template <> __device__ __forceinline__ float cast<float, bf16>(bf16 x) {
  return to_f(x);
}
template <> __device__ __forceinline__ bf16 cast<bf16, float>(float x) {
  return __float2bfloat16_rn(x);
}

// Vector type holding 4 elements of T.
template <typename T> struct Vec4 { using type = float4; };
template <> struct Vec4<bf16> { using type = uint2; };

template <typename S, typename D>
__device__ __forceinline__ void copy_body(const S* __restrict__ src,
                                          D* __restrict__ dst, long long n,
                                          int vectorised) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorised) {
    using VS = typename Vec4<S>::type;
    using VD = typename Vec4<D>::type;
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const VS x = reinterpret_cast<const VS*>(src)[i];
      if constexpr (std::is_same<S, D>::value) {
        reinterpret_cast<VD*>(dst)[i] = x;        // same type: move bits
      } else {
        const S* xs = reinterpret_cast<const S*>(&x);
        VD y;
        D* ys = reinterpret_cast<D*>(&y);
#pragma unroll
        for (int k = 0; k < 4; ++k) ys[k] = cast<D, S>(xs[k]);
        reinterpret_cast<VD*>(dst)[i] = y;
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = cast<D, S>(src[i]);
}

template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
write_flat_kernel(const S* __restrict__ src, D* __restrict__ arena_at,
                  long long n, int vectorised) {
  copy_body<S, D>(src, arena_at, n, vectorised);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
read_flat_kernel(const T* __restrict__ arena_at, T* __restrict__ out,
                 long long n, int vectorised) {
  copy_body<T, T>(arena_at, out, n, vectorised);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline int grid(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename S, typename D>
int launch_write(const void* src, void* arena, long long offset, long long n,
                 cudaStream_t stream) {
  D* at = static_cast<D*>(arena) + offset;
  const int vec = aligned(src, 4 * sizeof(S)) && aligned(at, 4 * sizeof(D));
  write_flat_kernel<S, D><<<grid(vec ? (n + 3) / 4 : n), kThreads, 0,
                            stream>>>(static_cast<const S*>(src), at, n, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_read(const void* arena, long long offset, long long n, void* out,
                cudaStream_t stream) {
  const T* at = static_cast<const T*>(arena) + offset;
  const int vec = aligned(at, 4 * sizeof(T)) && aligned(out, 4 * sizeof(T));
  read_flat_kernel<T><<<grid(vec ? (n + 3) / 4 : n), kThreads, 0, stream>>>(
      at, static_cast<T*>(out), n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// arena[offset : offset + n] = cast(src[0 : n]); src contiguous, arena of
// at least offset + n elements.  Returns a cudaError_t.
extern "C" int pack_write(void* arena, int arena_dt, const void* src,
                          int src_dt, long long offset, long long n,
                          void* stream) {
  if (n < 1 || offset < 0 || arena_dt < 0 || arena_dt > 1 || src_dt < 0 ||
      src_dt > 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arena_dt && src_dt) return launch_write<bf16, bf16>(src, arena, offset,
                                                          n, s);
  if (arena_dt) return launch_write<float, bf16>(src, arena, offset, n, s);
  if (src_dt) return launch_write<bf16, float>(src, arena, offset, n, s);
  return launch_write<float, float>(src, arena, offset, n, s);
}

// out[0 : n] = arena[offset : offset + n], both of type dt.  Returns a
// cudaError_t.
extern "C" int pack_read(const void* arena, int dt, long long offset,
                         long long n, void* out, void* stream) {
  if (n < 1 || offset < 0 || dt < 0 || dt > 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dt ? launch_read<bf16>(arena, offset, n, out, s)
            : launch_read<float>(arena, offset, n, out, s);
}
