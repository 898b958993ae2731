// Split-KV decode attention statistics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_stats_fwd` (body
// `_decode_kernel`) in src/repro/kernels/flash_decode/flash_decode.py.  For
// one query token per (batch, q-head) it returns the unnormalised
// online-softmax statistics over the key positions a `valid` mask admits:
//
//   acc (B,Hq,1,D) = sum_j p_j v_j,   m (B,Hq,1,1) = max_j s_j,
//   l   (B,Hq,1,1) = sum_j p_j,       s_j = (q . k_j) / sqrt(D),
//   p_j = exp(s_j - m),               all fp32,
//
// so shards of the key axis merge with a log-sum-exp combine (ref.combine).
// q head h reads kv head h / (Hq / Hkv) (GQA folded into the addressing).
//
// What bounds it: memory.  One call reads K and V once,
// 2*B*Hkv*L*D*itemsize bytes, and does 4*B*Hq*L*D flops: about one flop per
// byte in bf16 against the ~295 the tensor cores need before they, not HBM,
// are the limit.  So the design spends nothing on the tensor cores and
// everything on reading K/V once, in wide, coalesced loads:
//
//  * One thread block per (b, h).  The TPU kernel's sequential key-block grid
//    axis (carried in VMEM scratch) becomes a loop over key tiles of kTile
//    positions inside the block; the running (m, l, acc) live in registers.
//  * Each lane loads 16 bytes of a K or V row (8 bf16 or 4 fp32 values), and
//    G = D / VEC neighbouring lanes cover one row, so a warp reads whole
//    contiguous rows.  K/V are widened to fp32 in registers; q is held in
//    registers for the whole loop.
//  * Scores: each G-lane group dots its row segment with q and reduces with
//    shuffles; tile max and sum are block reductions in a fixed order, so two
//    runs on the same input give the same bits.
//  * Masking: positions with valid == 0 score NEG_INF = -1e30 (not -inf, so
//    a row with no valid key stays finite, as in the reference); positions
//    past L in the ragged last tile are skipped, never scored, so any L runs
//    through the kernel.
//
// Later work, not here: split-K across blocks when B*Hq is below the SM
// count, cp.async/TMA double buffering of the next tile, one K/V read shared
// by the q heads of a GQA group.
//
// C interface (bound with ctypes): `flash_decode_stats` launches on the given
// stream and returns cudaGetLastError(); invalid shapes return
// cudaErrorInvalidValue without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;      // key positions per tile
constexpr int kThreads = 128;   // one block: 4 warps, one thread per tile slot
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

static_assert(kThreads == kTile, "the tile reductions map one thread per key");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16-byte vector load of VEC consecutive elements, widened to fp32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_stats_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ acc_out,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out, int hq, int hkv, int L,
                          float scale) {
  constexpr int VEC = Vec<TKV>::N;
  constexpr int G = D / VEC;          // lanes per key row
  constexpr int R = kThreads / G;     // key rows in flight per pass
  static_assert(D % VEC == 0 && G <= 32 && 32 % G == 0,
                "a key row must split evenly over a power-of-two lane group");

  __shared__ float s_sh[kTile];       // this tile's scores, then p_j
  __shared__ float red_sh[kWarps];    // per-warp partials
  __shared__ float stat_sh[2];        // m_new, alpha of this tile
  __shared__ float acc_sh[R][D];      // row-group partials of acc

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int g = tid % G;              // segment of the row this lane holds
  const int row = tid / G;            // row group of this lane
  const int warp = tid / 32;
  const int lane = tid % 32;

  float qv[VEC];
  const TQ* qp = q + ((size_t)b * hq + h) * D + g * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = to_float(qp[i]);

  const size_t kv_base = ((size_t)b * hkv + kh) * (size_t)L * D + g * VEC;
  const TKV* kb = k + kv_base;
  const TKV* vb = v + kv_base;
  const uint8_t* ok = valid + (size_t)b * L;

  float m = kNegInf;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int tl = min(kTile, L - t0);

    // 1. scores.  The pass count is uniform across the block, so every lane
    //    reaches the shuffles even when the ragged tile leaves it no row.
    for (int r0 = 0; r0 < tl; r0 += R) {
      const int r = r0 + row;
      float part = 0.f;
      if (r < tl) {
        float kf[VEC];
        Vec<TKV>::load(kb + (size_t)(t0 + r) * D, kf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(qv[i], kf[i], part);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o, G);
      if (r < tl && g == 0) s_sh[r] = ok[t0 + r] ? part * scale : kNegInf;
    }
    __syncthreads();

    // 2. the tile's max, then the running max and the rescale factor.
    const float x = tid < tl ? s_sh[tid] : -INFINITY;
    const float wmax = warp_max(x);
    if (lane == 0) red_sh[warp] = wmax;
    __syncthreads();
    if (tid == 0) {
      float tmax = red_sh[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tmax = fmaxf(tmax, red_sh[w]);
      const float m_new = fmaxf(m, tmax);
      stat_sh[0] = m_new;
      stat_sh[1] = expf(m - m_new);
    }
    __syncthreads();
    const float m_new = stat_sh[0];
    const float alpha = stat_sh[1];

    // 3. p_j = exp(s_j - m_new) and the tile's sum of them.
    float p = 0.f;
    if (tid < tl) {
      p = expf(s_sh[tid] - m_new);
      s_sh[tid] = p;
    }
    const float wsum = warp_sum(p);
    if (lane == 0) red_sh[warp] = wsum;
    __syncthreads();
    float tsum = red_sh[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tsum += red_sh[w];
    l = alpha * l + tsum;
    m = m_new;

    // 4. acc = acc * alpha + sum_j p_j v_j over this lane's rows.
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
    for (int r = row; r < tl; r += R) {
      const float pr = s_sh[r];
      float vf[VEC];
      Vec<TKV>::load(vb + (size_t)(t0 + r) * D, vf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pr, vf[i], acc[i]);
    }
    __syncthreads();                  // s_sh and red_sh are reused next tile
  }

  // 5. sum the R row-group partials of each output element in a fixed order.
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc_sh[row][g * VEC + i] = acc[i];
  __syncthreads();
  const size_t o = (size_t)b * hq + h;
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += acc_sh[r][d];
    acc_out[o * D + d] = s;
  }
  if (tid == 0) {
    m_out[o] = m;
    l_out[o] = l;
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* acc, void* m, void* l, int B,
                   int hq, int hkv, int L, float scale, cudaStream_t stream) {
  const dim3 grid(hq, B);
  flash_decode_stats_kernel<TQ, TKV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), hq, hkv, L, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* valid, void* acc, void* m, void* l, int B,
                     int hq, int hkv, int L, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<TQ, TKV, 16>(q, k, v, valid, acc, m, l, B, hq, hkv, L,
                                 scale, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, valid, acc, m, l, B, hq, hkv, L,
                                 scale, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, valid, acc, m, l, B, hq, hkv, L,
                                  scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,1,D) and k/v (B,Hkv,L,D) contiguous, 16-byte aligned; valid (B,L)
// uint8; acc/m/l fp32 outputs.  q_bf16 / kv_bf16: 1 for bfloat16, 0 for
// float32.  Returns a cudaError_t.
extern "C" int flash_decode_stats(const void* q, const void* k, const void* v,
                                  const void* valid, void* acc, void* m,
                                  void* l, int B, int hq, int hkv, int L,
                                  int D, int q_bf16, int kv_bf16, float scale,
                                  void* stream) {
  if (B < 1 || hq < 1 || hkv < 1 || L < 1 || hq % hkv || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, valid, acc, m,
                                                  l, B, hq, hkv, L, scale, s);
  if (q_bf16)
    return launch_d<__nv_bfloat16, float>(D, q, k, v, valid, acc, m, l, B,
                                          hq, hkv, L, scale, s);
  if (kv_bf16)
    return launch_d<float, __nv_bfloat16>(D, q, k, v, valid, acc, m, l, B,
                                          hq, hkv, L, scale, s);
  return launch_d<float, float>(D, q, k, v, valid, acc, m, l, B, hq, hkv, L,
                                scale, s);
}
