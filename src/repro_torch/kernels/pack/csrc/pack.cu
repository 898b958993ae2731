// Arena pack and unpack copies for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/pack/pack.py:
//
//  * `write_rows_2d` (body `_copy_kernel`): writes one gradient bucket into
//    its segment of the communication arena, in place, cast to the arena's
//    dtype -> `pack_write` here;
//  * `read_rows_2d` (body `_slice_kernel`): copies one segment back out of
//    the arena into a fresh buffer -> `pack_read`.
//
// The arena (src/repro_torch/mem/arena.py) is one tensor allocated once and
// written in place every step, the port's form of the reference's donated,
// page-aligned buffer.  Both copies are exact: a same-type copy moves bits,
// and the only casts, fp32 -> bf16 (round to nearest even, as torch's
// `.to(torch.bfloat16)`) and bf16 -> fp32 (exact), equal their plain
// versions bit for bit.
//
// What bounds them: memory.  Each element is read once and written once
// (8 bytes per fp32 element), no flops, so the least time is
// bytes / 3.35 TB/s: 0.627 ms for the train layout's largest segment
// (262,668,288 fp32 elements, the tied embedding), 2.95 ms for one pack of
// the whole llama3.2-1b layout.  What reaches that rate is enough bytes in
// flight on every SM, with nothing else in the way.  Two routes, chosen by
// the wrapper before the launch (ops.route) and named in the call:
//
//  * "bulk" (kernel `bulk_copy_kernel`): a same-type copy whose source and
//    destination addresses are congruent mod 16 bytes -- every launch of the
//    train path (the arena's segments sit at 2 MiB pages, its buckets and
//    read-out buffers are allocated congruent to them).  Hopper's bulk-copy
//    engine moves the bytes: a persistent grid of kBulkBlocksPerSm blocks on
//    each SM (the SM count read from the device), block b taking chunks
//    b, b + G, b + 2G, ... of kStageBytes, so that the G blocks sweep the
//    copy front to back together (one contiguous share per block spreads
//    the front over the whole copy: 8 % slower), each chunk through a ring
//    of kStages shared-memory stages.  One thread issues
//    everything: `cp.async.bulk` global -> shared completing on the stage's
//    mbarrier (armed with the chunk's bytes), `cp.async.bulk` shared ->
//    global in a bulk group, and before a stage is refilled
//    `cp.async.bulk.wait_group.read` on the store that last read it (kLag
//    stores stay in flight).  The bytes never pass through registers, so the
//    copy is bitwise by construction.  Bulk copies need 16-byte-aligned
//    addresses and 16-byte-multiple sizes: the head up to the destination's
//    first 16-byte boundary and the tail after the last one (at most 15
//    bytes each) are copied byte by byte by block 0's lanes.
//  * "vector" (kernel `vector_copy_kernel`): the casting write (fp32 -> bf16,
//    bf16 -> fp32) and same-type copies whose addresses are not congruent
//    mod 16.  A grid of at most kVectorBlocksPerSm blocks per SM streams
//    4-element vectors (16 bytes of fp32, 8 of bf16) aligned on the
//    destination, each thread issuing kUnroll independent vector loads
//    before its first store, with streaming cache hints (__ldcs / __stcs:
//    nothing is reused).  Where the source's elements do not sit on its own
//    4-element boundaries there, each vector is shifted into place from
//    two aligned source vectors (the second is the next lane's first, so
//    it mostly hits L1).  Fewer than 8 elements at each end, and copies too
//    short for one vector, go one by one.
//
// Offsets and sizes are 64-bit throughout (byte offsets into the largest
// segment pass 2^31); only a chunk's byte count is 32-bit.  No host
// synchronisation and, after the first call on a device, no attribute
// setting, so a launch can be captured in a CUDA graph.  One launch per
// segment, like the reference; a grouped copy of every bucket in one launch
// is later work.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError(); a bad argument, or a "bulk" request
// whose dtypes differ or whose addresses are not congruent mod 16, returns
// cudaErrorInvalidValue without launching.  Type codes: 0 float32,
// 1 bfloat16.  Route codes: 0 bulk, 1 vector.  `pack_bulk_stage_bytes`
// returns kStageBytes, so that checks can size copies around one stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The bulk route's shape, picked on an H100 (PERF.md, the pack findings):
// the other shapes tried (4 KB to 64 KB stages, 2 to 8 of them, 1 to 8
// blocks per SM) came within 2 % of this one.
constexpr int kStageBytes = 32768;
constexpr int kStages = 4;
constexpr int kLag = 1;                         // stores left in flight
constexpr int kBulkBlocksPerSm = 1;
constexpr int kBulkThreads = 32;                // lanes 0-30: head and tail
constexpr int kBulkSmem = kStages * kStageBytes;
static_assert(kStageBytes % 16 == 0 && kStageBytes < (1 << 20),
              "a stage is a 16-byte multiple below the mbarrier's tx limit");
static_assert(kLag >= 0 && kLag < kStages, "a refill must precede its use");

constexpr int kThreads = 256;                   // vector route
constexpr int kUnroll = 4;                      // loads in flight per thread
constexpr int kVectorBlocksPerSm = 8;           // 2048 threads: a full SM
constexpr int kMaxDevices = 64;

constexpr int kBulk = 0, kVector = 1;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// waits until at most N committed bulk stores may still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- bulk

__global__ void __launch_bounds__(kBulkThreads)
bulk_copy_kernel(unsigned char* __restrict__ dst,
                 const unsigned char* __restrict__ src, long long nbytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];

  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(dst) & 15))
                   & 15;
  if (head > nbytes) head = nbytes;
  const long long tail = head + ((nbytes - head) & ~15LL);
  if (blockIdx.x == 0) {               // at most 15 bytes each side
    const int t = threadIdx.x;
    if (t < head) {
      dst[t] = src[t];
    } else if (t >= 16 && tail + (t - 16) < nbytes) {
      dst[tail + (t - 16)] = src[tail + (t - 16)];
    }
  }
  if (threadIdx.x != 0) return;

  // chunk j of this block is chunk blockIdx.x + j * gridDim.x of
  // [head, tail): the blocks sweep the copy front to back together
  const long long all = (tail - head + kStageBytes - 1) / kStageBytes;
  const long long chunks = all > blockIdx.x
      ? (all - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (chunks == 0) return;
  auto at_of = [&](long long j) {
    return head + (blockIdx.x + j * gridDim.x) * (long long)kStageBytes;
  };

  const uint32_t ring_s = smem_u32(ring), full_s = smem_u32(full);
  for (int s = 0; s < kStages; ++s) mbar_init(full_s + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  auto bytes_of = [&](long long c) -> uint32_t {
    const long long left = tail - at_of(c);
    return static_cast<uint32_t>(left < kStageBytes ? left : kStageBytes);
  };
  auto load = [&](long long c) {
    const int s = static_cast<int>(c % kStages);
    const uint32_t n = bytes_of(c);
    mbar_expect_tx(full_s + 8 * s, n);
    bulk_load(ring_s + s * kStageBytes, src + at_of(c), n, full_s + 8 * s);
  };

  for (long long c = 0; c < kStages && c < chunks; ++c) load(c);
  for (long long c = 0; c < chunks; ++c) {
    const int s = static_cast<int>(c % kStages);
    mbar_wait(full_s + 8 * s, static_cast<uint32_t>((c / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_store(dst + at_of(c), ring_s + s * kStageBytes, bytes_of(c));
    // refill the stage of chunk c - kLag once its store has read it
    const long long r = c - kLag;
    if (r >= 0 && r + kStages < chunks) {
      bulk_wait_read<kLag>();
      load(r + kStages);
    }
  }
  // the ring must outlive the stores' reads; wait for their writes too
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------- vector

template <typename D, typename S> __device__ __forceinline__ D cast(S x);
template <> __device__ __forceinline__ float cast<float, float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 cast<bf16, bf16>(bf16 x) {
  return x;
}
template <> __device__ __forceinline__ float cast<float, bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ bf16 cast<bf16, float>(float x) {
  return __float2bfloat16_rn(x);
}

// Vector type holding 4 elements of T.
template <typename T> struct Vec4 { using type = float4; };
template <> struct Vec4<bf16> { using type = uint2; };

template <typename D, typename S>
__device__ __forceinline__ typename Vec4<D>::type cast4(
    typename Vec4<S>::type x) {
  if constexpr (std::is_same<S, D>::value) {
    return x;                                   // same type: move bits
  } else {
    const S* xs = reinterpret_cast<const S*>(&x);
    typename Vec4<D>::type y;
    D* ys = reinterpret_cast<D*>(&y);
#pragma unroll
    for (int k = 0; k < 4; ++k) ys[k] = cast<D, S>(xs[k]);
    return y;
  }
}

// The 4 elements of S starting `m` (1-3) elements into `a`, continuing into
// `b` (a and b adjacent aligned vectors).
__device__ __forceinline__ float4 shift4(float4 a, float4 b, int m) {
  switch (m) {
    case 1: return make_float4(a.y, a.z, a.w, b.x);
    case 2: return make_float4(a.z, a.w, b.x, b.y);
    default: return make_float4(a.w, b.x, b.y, b.z);
  }
}
__device__ __forceinline__ uint2 shift4(uint2 a, uint2 b, int m) {
  const unsigned long long lo = (unsigned long long)a.y << 32 | a.x;
  const unsigned long long hi = (unsigned long long)b.y << 32 | b.x;
  const unsigned long long r = lo >> (16 * m) | hi << (64 - 16 * m);
  return make_uint2(static_cast<unsigned>(r), static_cast<unsigned>(r >> 32));
}

// store(i, load(i)) for i in [lo, hi), kUnroll loads in flight per thread
// before its stores; a warp's lanes take neighbouring items of each load.
template <typename X, typename Load, typename Store>
__device__ __forceinline__ void stream_loop(long long lo, long long hi,
                                            Load load, Store store) {
  constexpr long long kTile = (long long)kThreads * kUnroll;
  for (long long base = lo + blockIdx.x * kTile + threadIdx.x; base < hi;
       base += (long long)gridDim.x * kTile) {
    X x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < hi) x[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < hi) store(i, x[u]);
    }
  }
}

// dst[e] = cast(src[e]) for e < n.  4-vectors [v0, v1) of dst, vector v at
// element head + 4v (a 4-element boundary of dst); src's elements there sit
// `shift` elements past a 4-element boundary of src, so each comes from one
// aligned vector of src (shift 0) or two (shifted into place).  Elements
// outside the vectors (fewer than 8 on each side) go one by one; with no
// vectors (v1 == v0) every element does.
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
vector_copy_kernel(const S* __restrict__ src, D* __restrict__ dst,
                   long long n, long long head, int shift, long long v0,
                   long long v1) {
  auto one = [&](long long e) { dst[e] = cast<D, S>(__ldcs(src + e)); };
  if (v1 <= v0) {
    stream_loop<S>(0, n, [&](long long e) { return __ldcs(src + e); },
                   [&](long long e, S x) { __stcs(dst + e, cast<D, S>(x)); });
    return;
  }
  using VS = typename Vec4<S>::type;
  using VD = typename Vec4<D>::type;
  VD* d4 = reinterpret_cast<VD*>(dst + head);
  const VS* s4 = reinterpret_cast<const VS*>(src + head - shift);
  auto put = [&](long long v, VS x) { __stcs(d4 + v, cast4<D, S>(x)); };
  if (shift == 0) {
    stream_loop<VS>(v0, v1, [&](long long v) { return __ldcs(s4 + v); }, put);
  } else {
    stream_loop<VS>(v0, v1, [&](long long v) {
      return shift4(__ldcs(s4 + v), __ldcs(s4 + v + 1), shift);
    }, put);
  }
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long first = head + 4 * v0, last = head + 4 * v1;
  if (tid < first) one(tid);
  if (tid >= 8 && last + tid - 8 < n) one(last + tid - 8);
}

// ---------------------------------------------------------------- host

// The current device's SM count; on its first call on a device, also the
// bulk kernel's opt-in above 48 KB of shared memory, which holds for that
// device from then on.
cudaError_t device_sms(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(bulk_copy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBulkSmem);
    if (e != cudaSuccess) return e;
    cached[dev] = n;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

int launch_bulk(void* dst, const void* src, long long nbytes,
                cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(dst) - reinterpret_cast<uintptr_t>(src))
      & 15)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const long long chunks = ((nbytes & ~15LL) + kStageBytes - 1) / kStageBytes;
  long long blocks = (long long)kBulkBlocksPerSm * sms;
  if (blocks > chunks) blocks = chunks;
  if (blocks < 1) blocks = 1;
  bulk_copy_kernel<<<(int)blocks, kBulkThreads, kBulkSmem, stream>>>(
      static_cast<unsigned char*>(dst), static_cast<const unsigned char*>(src),
      nbytes);
  return (int)cudaGetLastError();
}

// elements to the next 4-element boundary of p
template <typename T> inline long long to_vec4(const void* p) {
  return (-(long long)(reinterpret_cast<uintptr_t>(p) / sizeof(T))) & 3;
}

template <typename S, typename D>
int launch_vector(const void* src, void* dst, long long n,
                  cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  // dst's 4-element boundaries from element `head` on; src's elements there
  // sit `shift` past its own, so vector v reads src vectors v (and v + 1
  // when shifted): keep those reads inside [0, n)
  const long long head = to_vec4<D>(dst);
  const int shift = static_cast<int>((4 - to_vec4<S>(src) + head) & 3);
  long long v0 = 0, v1 = 0;
  if (n >= head + 8) {
    v0 = head < shift ? 1 : 0;
    v1 = shift ? (n - head + shift - 8) / 4 + 1 : (n - head) / 4;
  }
  const long long work = v1 > v0 ? v1 - v0 : n;
  long long blocks = (work + (long long)kThreads * kUnroll - 1)
                     / ((long long)kThreads * kUnroll);
  if (blocks > (long long)kVectorBlocksPerSm * sms)
    blocks = (long long)kVectorBlocksPerSm * sms;
  if (blocks < 1) blocks = 1;
  vector_copy_kernel<S, D><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(src), static_cast<D*>(dst), n, head, shift, v0,
      v1);
  return (int)cudaGetLastError();
}

int itemsize(int dt) { return dt ? 2 : 4; }

// dst[0:n] (type code dd) = cast(src[0:n]) (type code sd) on `route`
int copy_on_route(void* dst, int dd, const void* src, int sd, long long n,
                  int route, cudaStream_t s) {
  if (route == kBulk) {
    if (dd != sd) return cudaErrorInvalidValue;
    return launch_bulk(dst, src, n * itemsize(dd), s);
  }
  if (dd && sd) return launch_vector<bf16, bf16>(src, dst, n, s);
  if (dd) return launch_vector<float, bf16>(src, dst, n, s);
  if (sd) return launch_vector<bf16, float>(src, dst, n, s);
  return launch_vector<float, float>(src, dst, n, s);
}

}  // namespace

// arena[offset : offset + n] = cast(src[0 : n]); src contiguous, arena of
// at least offset + n elements.  Returns a cudaError_t.
extern "C" int pack_write(void* arena, int arena_dt, const void* src,
                          int src_dt, long long offset, long long n,
                          int route, void* stream) {
  if (n < 1 || offset < 0 || arena_dt < 0 || arena_dt > 1 || src_dt < 0 ||
      src_dt > 1 || (route != kBulk && route != kVector))
    return cudaErrorInvalidValue;
  void* at = static_cast<unsigned char*>(arena) + offset * itemsize(arena_dt);
  return copy_on_route(at, arena_dt, src, src_dt, n, route,
                       static_cast<cudaStream_t>(stream));
}

// out[0 : n] = arena[offset : offset + n], both of type dt.  Returns a
// cudaError_t.
extern "C" int pack_read(const void* arena, int dt, long long offset,
                         long long n, void* out, int route, void* stream) {
  if (n < 1 || offset < 0 || dt < 0 || dt > 1 ||
      (route != kBulk && route != kVector))
    return cudaErrorInvalidValue;
  const void* at =
      static_cast<const unsigned char*>(arena) + offset * itemsize(dt);
  return copy_on_route(out, dt, at, dt, n, route,
                       static_cast<cudaStream_t>(stream));
}

// The bulk route's chunk: bytes per shared-memory stage.
extern "C" int pack_bulk_stage_bytes() { return kStageBytes; }
