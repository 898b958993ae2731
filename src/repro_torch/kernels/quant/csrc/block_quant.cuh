// Block-absmax int8 quantisation, the device code shared by quant.cu (the
// ring's per-hop codec) and pack_quant.cu (the arena's fused pack+quantize).
//
// Per quant block of `block` fp32 values x:
//
//   scale = max(absmax(x) / 127, FLT_MIN)
//   q     = clip(rint(x / scale), -127, 127)          (int8)
//   r     = x - q * scale                              (the residual)
//
// and back, x' = q * scale.  This is the arithmetic of the reference's
// Int8BlockCodec and of its Pallas kernels, and of the plain PyTorch
// versions beside these kernels, operation for operation, so the results
// are equal bit for bit:
//   * `x / scale` and `absmax / 127` are IEEE divisions (no reciprocal; the
//     build has no --use_fast_math);
//   * rintf rounds half to even, like torch.round and jnp.round;
//   * the residual is __fsub_rn(x, __fmul_rn(q, scale)): nvcc would
//     otherwise contract x - q * scale into one FMA, which rounds once where
//     the plain version rounds twice;
//   * a block of zeros gives scale FLT_MIN and q 0;
//   * the residual subtracts q as the int8 round trip gives it back: a
//     small negative quotient rounds to -0, which the int8 value stores
//     as 0, so q is canonicalised to +0 before the multiply (for x = -0
//     the residual is then -0, as in the plain version, not +0);
//   * NaN propagates as in torch.amax, torch.maximum and torch.clamp: a
//     block holding a NaN gets a NaN scale, and so decodes to NaN and
//     leaves a NaN residual; a block holding an inf gets an inf scale.
//     Every quotient x / scale of such a block is 0 or NaN, and a NaN
//     becomes q 0, as XLA's float-to-int conversion makes of it in the
//     reference on the CPU (the plain version says so explicitly): a block
//     whose scale is not finite is all q 0.  fmaxf and fminf would drop
//     the NaN instead.
//
// Design: one warp per quant block, any block size, blocks visited by a
// grid-stride loop over warps.  Pass 1 reduces the absmax as an unsigned
// max of the values' magnitude bits (one integer max per value, one
// __reduce_max_sync per warp; NaN bits lie above inf's, so NaN wins as in
// torch.amax); pass 2 writes q and the residual.  A block of at most 512
// values stays in registers between the passes (16 per lane), all of a
// lane's loads issued before the first is used; a wider one is read twice,
// the second time mostly from L1/L2.  The decode issues its loads the same
// way.  Lanes move 4 consecutive values with one 16-byte load (4 bytes of
// int8) when the block is a multiple of 4 values and every pointer is
// aligned to that, else one value each; both ways a warp's accesses are
// contiguous.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace block_quant {

constexpr int kThreads = 256;                 // 8 warps per thread block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;           // 8 resident on each of 132 SMs
constexpr int kCached = 16;                   // values a lane keeps in regs

// |v| as bits: for non-negative floats the unsigned order of the bits is
// the order of the values, and every NaN's bits lie above inf's.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// scale = max(absmax / 127, FLT_MIN), NaN kept, from each lane's absmax
// bits.
__device__ __forceinline__ float block_scale(unsigned lane_amax) {
  const float s =
      __uint_as_float(__reduce_max_sync(0xffffffffu, lane_amax)) / 127.0f;
  return s != s ? s : fmaxf(s, FLT_MIN);
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_q(const int8_t* p, float* v) {
  if constexpr (VEC == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<char4*>(p) =
        make_char4((signed char)v[0], (signed char)v[1], (signed char)v[2],
                   (signed char)v[3]);
  } else {
    *p = (int8_t)v[0];
  }
}

// x = src (+ ef) at element i of a block.
template <int VEC, bool EF>
__device__ __forceinline__ void load_x(const float* src, const float* ef,
                                       long long i, float* v) {
  load<VEC>(src + i, v);
  if constexpr (EF) {
    float e[VEC];
    load<VEC>(ef + i, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fadd_rn(v[k], e[k]);
  }
}

// q (as a float holding an integer) and the residual of VEC values, in place:
// v becomes the residual.  `finite` is whether the block's scale is.
template <int VEC>
__device__ __forceinline__ void encode(float* v, float* q, float scale,
                                       bool finite) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    // + 0 turns -0 into +0 (an IEEE add that nvcc may not drop)
    q[k] = finite ? __fadd_rn(fminf(fmaxf(rintf(v[k] / scale), -127.0f),
                                    127.0f), 0.0f)
                  : 0.0f;
    v[k] = __fsub_rn(v[k], __fmul_rn(q[k], scale));
  }
}

// Quantizes quant block `b` of `src` (+ `ef`) into `q` (int8) and
// `scales[b]`; with EF, writes the residual back into `ef`.  One warp.
template <int VEC, bool EF>
__device__ __forceinline__ void quantize_block(const float* __restrict__ src,
                                               float* ef,
                                               int8_t* __restrict__ q,
                                               float* __restrict__ scales,
                                               long long b, int block,
                                               int lane) {
  const long long base = b * (long long)block;
  const float* s = src + base;
  float* e = EF ? ef + base : nullptr;
  int8_t* qb = q + base;
  constexpr int kIters = kCached / VEC;
  unsigned amax = 0;
  if (block <= 32 * kCached) {                 // registers hold the block
    float v[kCached];
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = (j * 32 + lane) * VEC;
      if (i < block) {
        load_x<VEC, EF>(s, e, i, v + j * VEC);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          amax = umax(amax, abs_bits(v[j * VEC + k]));
      }
    }
    const float scale = block_scale(amax);
    const bool finite = scale <= FLT_MAX;
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = (j * 32 + lane) * VEC;
      if (i < block) {
        float qv[VEC];
        encode<VEC>(v + j * VEC, qv, scale, finite);
        store_q<VEC>(qb + i, qv);
        if constexpr (EF) store<VEC>(e + i, v + j * VEC);
      }
    }
    if (lane == 0) scales[b] = scale;
    return;
  }
  for (int i = lane * VEC; i < block; i += 32 * VEC) {
    float v[VEC];
    load_x<VEC, EF>(s, e, i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) amax = umax(amax, abs_bits(v[k]));
  }
  const float scale = block_scale(amax);
  const bool finite = scale <= FLT_MAX;
  for (int i = lane * VEC; i < block; i += 32 * VEC) {
    float v[VEC], qv[VEC];
    load_x<VEC, EF>(s, e, i, v);
    encode<VEC>(v, qv, scale, finite);
    store_q<VEC>(qb + i, qv);
    if constexpr (EF) store<VEC>(e + i, v);
  }
  if (lane == 0) scales[b] = scale;
}

// out = q * scales[b] over quant block `b`.  One warp.
template <int VEC>
__device__ __forceinline__ void dequantize_block(
    const int8_t* __restrict__ q, const float* __restrict__ scales,
    float* __restrict__ out, long long b, int block, int lane) {
  const long long base = b * (long long)block;
  const float scale = scales[b];
  constexpr int kIters = kCached / VEC;
  if (block <= 32 * kCached) {       // all of a lane's loads in flight first
    float v[kCached];
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = (j * 32 + lane) * VEC;
      if (i < block) load_q<VEC>(q + base + i, v + j * VEC);
    }
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = (j * 32 + lane) * VEC;
      if (i < block) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          v[j * VEC + k] = __fmul_rn(v[j * VEC + k], scale);
        store<VEC>(out + base + i, v + j * VEC);
      }
    }
    return;
  }
  for (int i = lane * VEC; i < block; i += 32 * VEC) {
    float v[VEC];
    load_q<VEC>(q + base + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(v[k], scale);
    store<VEC>(out + base + i, v);
  }
}

// This thread's lane, its warp's first quant block and the warp count of
// the grid: warp w takes blocks w, w + warps, w + 2 * warps, ...
struct WarpLoop {
  int lane;
  long long first;
  long long stride;
};

__device__ __forceinline__ WarpLoop warp_loop() {
  return {(int)(threadIdx.x & 31),
          ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5,
          ((long long)gridDim.x * blockDim.x) >> 5};
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline int grid(long long n_blocks) {
  long long ctas = (n_blocks + kWarps - 1) / kWarps;
  if (ctas > kMaxBlocks) ctas = kMaxBlocks;
  return ctas < 1 ? 1 : (int)ctas;
}

}  // namespace block_quant
