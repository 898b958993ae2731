// Blockwise (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (body `_attn_kernel`)
// in src/repro/kernels/flash_attn/flash_attn.py.  For q (B,Hq,S,D) and k, v
// (B,Hkv,S,D) it returns, per (batch, q head, query row),
//
//   out = sum_j p_j v_j / max(sum_j p_j, 1e-30),   p_j = exp(s_j - max_j s_j),
//   s_j = (q . k_j) / sqrt(D) where the mask admits key j, else -1e30,
//
// with the mask `k_pos <= q_pos` (causal) and `k_pos > q_pos - window`
// (optional sliding window), positions numbered from 0 on both axes.  q head
// h reads kv head h / (Hq / Hkv): GQA is folded into the addressing.  The
// softmax is online over key tiles in fp32 (running max m, denominator l,
// accumulator acc), as in the TPU kernel; the output is cast to q's dtype.
//
// What bounds it: operations.  A causal call does 4*B*Hq*D*S*(S+1)/2 flops
// on 2*B*(Hq+Hkv)*S*D*itemsize bytes, thousands of flops per byte at the
// prefill's lengths.  This first version is simple and right, not fast: it
// runs the products as fp32 FMAs on the CUDA cores (67 TFLOP/s peak) and
// leaves the bf16 tensor cores (989 TFLOP/s) to later work (wgmma fed by
// TMA, a pipeline of K/V tiles).  Its design:
//
//  * One block of 128 threads per (b, h, tile of kBQ = 64 query rows).  The
//    TPU kernel's sequential key-tile grid axis (m, l, acc carried in VMEM
//    scratch) becomes a loop over key tiles of kBK = 64 inside the block;
//    m, l and acc live in registers.  Blocks are issued longest-first (the
//    last query tiles see the most keys under the causal mask).
//  * Q is staged in shared memory once, K and V once per key tile, all
//    widened to fp32.  Each thread computes a 4 x 8 patch of the 64 x 64
//    score tile (4 query rows, keys tx + 8j), so a row's max and sum are
//    shuffles among 8 neighbouring lanes, and then 4 rows x D/8 columns of
//    P.V from the tile of p staged in shared memory.  Tile row strides are
//    padded (D + 1, kBK + 2) so that the column walks hit distinct banks.
//  * Tiles wholly in the future (causal) or wholly out of the window are
//    skipped, as in the TPU kernel.  A ragged last tile is masked: keys past
//    S score -1e30 against zero K/V rows, and rows past S are not written,
//    so any S >= 1 runs through the kernel.
//  * No atomics and a fixed order of every sum: two runs on the same input
//    give the same bits.
//
// C interface (bound with ctypes): `flash_attention_fwd` launches on the
// given stream and returns cudaGetLastError(); invalid shapes return
// cudaErrorInvalidValue without launching.  Strides are in elements; the
// last axis of q, k and v must be contiguous, the output is (B,Hq,S,D)
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key positions per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;        // query rows per thread
constexpr int kLanes = 8;       // lanes sharing a query row
constexpr int kKeys = kBK / kLanes;   // keys per thread per tile
constexpr float kNegInf = -1e30f;

static_assert(kThreads / kLanes * kRows == kBQ,
              "the row groups must cover the query tile");
static_assert(kBQ == kBK, "the causal tile skip assumes square tiles");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, kLanes));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o, kLanes);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 2));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int hq, int hkv, long long q_sb, long long q_sh,
                      long long q_ss, long long k_sb, long long k_sh,
                      long long k_ss, long long v_sb, long long v_sh,
                      long long v_ss, float scale, int causal, int window) {
  constexpr int LD = D + 1;           // row stride of the Q, K, V tiles
  constexpr int LP = kBK + 2;         // row stride of the p tile
  constexpr int DPT = D / kLanes;     // output columns per thread
  static_assert(D % kLanes == 0, "D must split over the row's lanes");

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;        // keys tx + kLanes * j, columns alike
  const int r0 = tid / kLanes * kRows;  // first of this thread's rows

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] = q0 + r < S ? to_float(qb[(q0 + r) * q_ss + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // the key tiles the TPU kernel runs for this query tile: not wholly in the
  // future (k_start <= q_start + kBQ - 1), not wholly out of the window
  // (k_start + kBK - 1 >= q_start - window + 1)
  const int nk = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 2 - kBK;
    if (lo > 0) kt_begin = (lo + kBK - 1) / kBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // Q stored; the last tile's K, V, p read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      ks[r * LD + c] = in ? to_float(kb[(k0 + r) * k_ss + c]) : 0.f;
      vs[r * LD + c] = in ? to_float(vb[(k0 + r) * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // 1. this thread's 4 x 8 patch of q . k
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + kLanes * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // 2. mask, scale, and the online softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kp = k0 + tx + kLanes * j;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(r0 + i) * LP + tx + kLanes * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // 3. acc += p . v over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(r0 + i) * LP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = vs[j * LD + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + ((long long)b * hq + h) * S * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      store(ob + (long long)row * D + tx + kLanes * c, acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int hq, int hkv, int S, const long long* st,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB only after opting in; once per kernel (and per process: the
  // port drives one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBQ - 1) / kBQ, hq, B);
  flash_attn_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, hq, hkv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int hq, int hkv, int S,
                     const long long* st, float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, hq, hkv, S, st, scale, causal,
                           window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, hq, hkv, S, st, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, hq, hkv, S, st, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, hq, hkv, S, st, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,S,D), k/v (B,Hkv,S,D), all of one dtype (bf16 = 1: bfloat16, 0:
// float32), with the given element strides of the batch, head and sequence
// axes; o (B,Hq,S,D) contiguous, q's dtype.  window <= 0: no window.
// Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int hq,
    int hkv, int S, int D, int bf16, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int window, void* stream) {
  if (B < 1 || hq < 1 || hkv < 1 || S < 1 || hq % hkv || B > 65535 ||
      hq > 65535)
    return cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, hq, hkv, S, st, scale,
                                   causal, window, s);
  return launch_d<float>(D, q, k, v, o, B, hq, hkv, S, st, scale, causal,
                         window, s);
}
