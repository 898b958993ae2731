// Blockwise (flash) attention forward for Hopper (sm_90a) on TF32 tensor
// cores at fp32 accuracy: the "mma" route of `flash_attention`.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (body `_attn_kernel`)
// in src/repro/kernels/flash_attn/flash_attn.py for fp32 q, k, v, and for
// bf16 q, k, v in layouts TMA cannot take (bf16 in TMA's layouts goes to
// flash_attn_wgmma.cu; the wrapper chooses before it launches).  For q
// (B,Hq,S,D) and k, v (B,Hkv,S,D) it returns, per (batch, q head, query row),
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
// prefill's lengths.  fp32 FMAs on the CUDA cores peak at 67 TFLOP/s; the
// TF32 tensor cores at 495 TFLOP/s dense, on 10-bit mantissas.  So:
//
//  * 3xTF32.  Both products, S = Q.K^T and acc += P.V, are
//    `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32` with fp32 accumulators.
//    Each fp32 operand x is split into big = cvt.rna.tf32(x) and small =
//    cvt.rna.tf32(x - big), and a product is big.small + small.big +
//    big.big, the small terms issued first (CUTLASS's OpMultiplyAddFastF32).
//    x - big is exact and small carries x to about 2^-22 relative; the
//    dropped small.small term is about 2^-22 of the product.  So a score or
//    an output is fp32-accurate up to a few 2^-22 relative and the order of
//    the sums, within the reference's 2e-5; one TF32 product (big.big
//    alone) is off by about 2^-11 and is not (ref.attention_tf32_split
//    models both).  bf16 inputs widened to fp32 are exact in TF32 (8
//    significant bits against 11), so their small halves are zero and the
//    kernel drops those products at compile time: Q.K^T takes one mma a
//    k-step, P.V two (p is fp32).
//  * No long sum through the tensor cores.  Their fp32 sums truncate (up
//    to an ulp each, always toward zero), so a chain of them is biased:
//    with acc chained through every key of a 4096-key row, a 16-layer fp32
//    prefill's logits came out about 9x further (relative L2) from the
//    plain prefill's than with fp32 FMAs and missed rtol/atol 1e-4 on
//    thousands of logits.  So each key tile's P.V is summed into
//    registers of its own (8 key steps) and folded into acc with one fp32
//    FMA, acc = alpha acc + pv, and the small terms of Q.K^T sum apart from
//    big.big, added once at the end.
//  * One block of 8 warps per (b, h, tile of kBQ = 128 query rows), 16 rows
//    a warp: each warp's m16 tiles hold its rows' scores, p and acc in
//    registers (acc is D/2 registers a lane; Q never lives in registers).
//    Key tiles of kBK = 64 run through a 2-stage cp.async ring: 16-byte
//    copies where the wrapper reports every K/V row 16-byte aligned, else
//    4-byte copies (fp32) or plain loads (bf16), a template switch chosen
//    before the launch.
//  * Q is loaded into shared memory once per block, widened to fp32, and
//    its fragment split at each k-step: 4 of the 20 splits a lane does per
//    k-step of Q.K^T, the other 16 being K's.  Splitting Q once per block
//    into big and small tiles was measured slower at fp32 D = 64 (2.02
//    against 1.94 ms at the timed shape; halves side by side, one 16-byte
//    read a row, 2.10 against 1.96; the same bits): a split Q doubles Q's
//    shared-memory reads, and they cost more than the splits they save.
//    At D = 128 a split Q (136 KB) and the two K/V stages (134 KB) would
//    not fit in the SM's 227 KB at all.
//  * P is reused as the A operand without a shuffle.  The m16n8 C fragment
//    of S gives a lane columns (2t, 2t+1) of its row; the tf32 A fragment of
//    m16n8k8 takes columns (t, t+4).  P.V sums over keys in any order, so V's
//    B fragment is read with its rows permuted to match: k = t <-> key 2t,
//    k = t + 4 <-> key 2t + 1.  Q.K^T likewise pairs head dims (2t, 2t + 1)
//    of each k-step, so a lane reads two adjacent floats of Q and of K; V's
//    columns are permuted so that a lane reads 4 adjacent floats for 4
//    n-tiles at once, and the store puts them back in order.
//  * Row strides are padded (Q and K: D + 8; V: D + 4 at fp32, D + 8 at
//    bf16) so that every fragment read hits distinct banks.
//  * Tiles wholly in the future (causal) or wholly out of the window are
//    skipped, by the block and, inside a block, by each warp for its 16
//    rows (a skipped tile adds exactly 0 or is wiped by alpha = 0 in the
//    reference's arithmetic too); masks are computed only on the tiles that
//    cross a boundary.  Blocks are issued longest-first.  A ragged last
//    tile is masked: keys past S score -1e30 against zero-filled K/V rows,
//    and rows past S are not written, so any S >= 1 runs through the kernel.
//  * No atomics, no split-K, and a fixed order of every sum: two runs on the
//    same input give the same bits.
//
// Why not `wgmma`: with .tf32 it takes only K-major operands from shared
// memory, so P.V's V (N-major as it lies) would need a transposed, split
// copy in shared memory every tile; that is left to later work.
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

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 a warp
constexpr int kBK = 64;            // keys per tile
constexpr int kNT = kBK / 8;       // n-tiles of a warp's score tile
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

// padded row strides in elements (the note's bank argument)
template <int D>
__host__ __device__ constexpr int ld_q() { return D + 8; }
template <int D>
__host__ __device__ constexpr int ld_k() { return D + 8; }
template <typename T, int D>
__host__ __device__ constexpr int ld_v() {
  return sizeof(T) == 4 ? D + 4 : D + 8;
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * kBQ * ld_q<D>()
       + kStages * sizeof(T) * kBK * (ld_k<D>() + ld_v<T, D>());
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 2^-22 relative, both exact in TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b, m16n8k8, tf32 in, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// N adjacent elements of shared memory as floats (N * sizeof(T) bytes,
// aligned to that)
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    static_assert(N == 2, "2 or 4 floats");
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    static_assert(N == 2, "2 or 4 bf16");
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(v << 16); x[1] = __uint_as_float(v & 0xffff0000u);
  }
}

// N adjacent outputs (N * sizeof(T) bytes, aligned to that)
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1],
                                                    x[i + 2], x[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[N]) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the K and V rows k0 .. k0 + kBK - 1 into one stage, rows past S zero
template <typename T, int D, bool kVec16>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const T* kb,
                                        const T* vb, long long k_ss,
                                        long long v_ss, int k0, int S,
                                        int tid) {
  constexpr int LK = ld_k<D>(), LV = ld_v<T, D>();
  if constexpr (kVec16) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kChunks = D / kPer;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks * kPer;
      const bool in = k0 + r < S;
      const long long row = in ? k0 + r : 0;   // nothing is read when !in
      cp_async16(ks + r * LK + c, kb + row * k_ss + c, in);
      cp_async16(vs + r * LV + c, vb + row * v_ss + c, in);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const long long row = in ? k0 + r : 0;
      cp_async4(ks + r * LK + c, kb + row * k_ss + c, in);
      cp_async4(vs + r * LV + c, vb + row * v_ss + c, in);
    }
  } else {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const T zero = __float2bfloat16(0.f);
      ks[r * LK + c] = in ? kb[(long long)(k0 + r) * k_ss + c] : zero;
      vs[r * LV + c] = in ? vb[(long long)(k0 + r) * v_ss + c] : zero;
    }
  }
}

template <typename T, int D, bool kVec16>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int hq, int hkv, long long q_sb, long long q_sh,
                      long long q_ss, long long k_sb, long long k_sh,
                      long long k_ss, long long v_sb, long long v_sh,
                      long long v_ss, float scale, int causal, int window) {
  constexpr bool kSplit = sizeof(T) == 4;   // bf16's small halves are 0
  constexpr int LQ = ld_q<D>(), LK = ld_k<D>(), LV = ld_v<T, D>();
  constexpr int kDT = D / 8;                // n-tiles of acc, k-steps of q.k
  constexpr int R = D >= 32 ? 4 : 2;        // acc n-tiles a V read feeds
  static_assert(D % 16 == 0 && kDT % R == 0, "D in {16, 32, 64, 128}");

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* kv_base = reinterpret_cast<T*>(smem + sizeof(float) * kBQ * LQ);
  constexpr int kStage = kBK * (LK + LV);   // elements of one stage

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // the mma fragments' indices
  const int r_lo = q0 + 16 * warp;          // this warp's first row

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

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

  if (kt_begin < kt_end) {
    load_kv<T, D, kVec16>(kv_base, kv_base + kBK * LK, kb, vb, k_ss, v_ss,
                          kt_begin * kBK, S, tid);
    cp_async_commit();
  }
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LQ + c] =
        q0 + r < S ? to_float(qb[(long long)(q0 + r) * q_ss + c]) : 0.f;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  const float* qw = qs + 16 * warp * LQ;
  int stage = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, stage ^= 1) {
    const int k0 = kt * kBK;
    if (kt + 1 < kt_end) {
      T* next = kv_base + (stage ^ 1) * kStage;
      load_kv<T, D, kVec16>(next, next + kBK * LK, kb, vb, k_ss, v_ss,
                            k0 + kBK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // Q and tile kt in shared memory

    const T* ks = kv_base + stage * kStage;
    const T* vs = ks + kBK * LK;
    // this warp's rows r_lo .. r_lo + 15 against keys k0 .. k0 + kBK - 1
    const bool run =
        r_lo < S && !(causal && k0 > r_lo + 15) &&
        !(window > 0 && k0 + kBK - 1 <= r_lo - window);
    if (run) {
      // 1. S = Q K^T: k-step kk pairs head dims 8kk + 2t, 8kk + 2t + 1
      // (s: the big.big products; sc: the small terms, a chain of their
      // own, so that the long chain of large partial sums is half as long)
      float s[kNT][4], sc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = sc[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        float x[2], y[2];
        load_vec<2>(qw + g * LQ + 8 * kk + 2 * t, x);
        load_vec<2>(qw + (g + 8) * LQ + 8 * kk + 2 * t, y);
        // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        const float af[4] = {x[0], y[0], x[1], y[1]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kSplit) split(af[i], ab[i], as[i]);
          else ab[i] = __float_as_uint(af[i]);
        }
        uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float z[2];
          load_vec<2>(ks + (8 * j + g) * LK + 8 * kk + 2 * t, z);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (kSplit) split(z[i], bb[j][i], bs[j][i]);
            else bb[j][i] = __float_as_uint(z[i]);
          }
        }
        if constexpr (kSplit) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(sc[j], ab, bs[j]);
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(sc[j], as, bb[j]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(s[j], ab, bb[j]);
      }
      if constexpr (kSplit) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = sc[j][c] + s[j][c];
      }

      // 2. scale, mask where the tile crosses a boundary, online softmax.
      // s[j][c]: row g + 8 (c / 2), key k0 + 8j + 2t + c % 2
      const bool edge = (causal && k0 + kBK - 1 > r_lo) || k0 + kBK > S ||
                        (window > 0 && k0 <= r_lo + 15 - window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[j][c] * scale;
          if (edge) {
            const int qp = r_lo + g + 8 * (c / 2);
            const int kp = k0 + 8 * j + 2 * t + c % 2;
            bool ok = kp < S;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            x = ok ? x : kNegInf;
          }
          s[j][c] = x;
          mx[c / 2] = fmaxf(mx[c / 2], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = expf(s[j][c] - m[c / 2]);
          sum[c / 2] += s[j][c];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = alpha[i] * l[i] + sum[i];
      }

      // 3. acc = alpha acc + P V.  The tile's P V is summed on the tensor
      // cores into registers of its own and folded into acc with one fp32
      // FMA: the tensor cores' fp32 sums truncate, and a chain through
      // every key of a long row would bias acc (about S/8 truncations
      // against S/64 rounded folds).  Key step j takes p's C fragment as
      // the A fragment (k = t <-> key 8j + 2t, k = t + 4 <-> key 8j + 2t
      // + 1) and V's rows alike; n-tile n, column i <-> head dim
      // 8R (n / R) + R i + n % R.
      float pv[kDT][4];
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[n][c] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float pf[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(pf[i], pb[i], ps[i]);
#pragma unroll
        for (int n0 = 0; n0 < kDT; n0 += R) {
          uint32_t vbig[R][2], vsmall[R][2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float z[R];
            load_vec<R>(vs + (8 * j + 2 * t + i) * LV + R * g + 8 * n0, z);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if constexpr (kSplit) split(z[r], vbig[r][i], vsmall[r][i]);
              else vbig[r][i] = __float_as_uint(z[r]);
            }
          }
          if constexpr (kSplit) {
#pragma unroll
            for (int r = 0; r < R; ++r) mma_tf32(pv[n0 + r], pb, vsmall[r]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) mma_tf32(pv[n0 + r], ps, vbig[r]);
#pragma unroll
          for (int r = 0; r < R; ++r) mma_tf32(pv[n0 + r], pb, vbig[r]);
        }
      }
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[n][c] = fmaf(acc[n][c], alpha[c / 2], pv[n][c]);
    }
    __syncthreads();                  // every warp done with this stage
  }

  // acc n-tiles n0 .. n0 + R - 1, columns 2t and 2t + 1, are head dims
  // 8 n0 + 2R t .. 8 n0 + 2R t + 2R - 1 in order
  T* ob = o + ((long long)b * hq + h) * S * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + g + 8 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n0 = 0; n0 < kDT; n0 += R) {
      float out[2 * R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out[r] = acc[n0 + r][2 * i] / den;
        out[R + r] = acc[n0 + r][2 * i + 1] / den;
      }
      store_vec<2 * R>(ob + (long long)row * D + 8 * n0 + 2 * R * t, out);
    }
  }
}

template <typename T, int D, bool kVec16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int hq, int hkv, int S, const long long* st,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static_assert(smem <= 227 * 1024, "shared memory above the SM's 227 KB");
  // above 48 KB only after opting in: once per instantiation (the port
  // drives one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<T, D, kVec16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBQ - 1) / kBQ, hq, B);
  flash_attn_fwd_kernel<T, D, kVec16><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, hq, hkv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_vec(int vec16, const void* q, const void* k, const void* v,
                       void* o, int B, int hq, int hkv, int S,
                       const long long* st, float scale, int causal,
                       int window, cudaStream_t stream) {
  return vec16 ? launch<T, D, true>(q, k, v, o, B, hq, hkv, S, st, scale,
                                    causal, window, stream)
               : launch<T, D, false>(q, k, v, o, B, hq, hkv, S, st, scale,
                                     causal, window, stream);
}

template <typename T>
cudaError_t launch_d(int D, int vec16, const void* q, const void* k,
                     const void* v, void* o, int B, int hq, int hkv, int S,
                     const long long* st, float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_vec<T, 16>(vec16, q, k, v, o, B, hq, hkv, S, st, scale,
                               causal, window, stream);
    case 32:
      return launch_vec<T, 32>(vec16, q, k, v, o, B, hq, hkv, S, st, scale,
                               causal, window, stream);
    case 64:
      return launch_vec<T, 64>(vec16, q, k, v, o, B, hq, hkv, S, st, scale,
                               causal, window, stream);
    case 128:
      return launch_vec<T, 128>(vec16, q, k, v, o, B, hq, hkv, S, st, scale,
                                causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,S,D), k/v (B,Hkv,S,D), all of one dtype (bf16 = 1: bfloat16, 0:
// float32), with the given element strides of the batch, head and sequence
// axes; o (B,Hq,S,D) contiguous, q's dtype.  vec16 = 1 only if every row of
// k and v starts 16-byte aligned (their base addresses and strides), which
// lets K/V tiles move in 16-byte copies.  window <= 0: no window.  Returns
// a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int hq,
    int hkv, int S, int D, int bf16, int vec16, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int window, void* stream) {
  if (B < 1 || hq < 1 || hkv < 1 || S < 1 || hq % hkv || B > 65535 ||
      hq > 65535)
    return cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(D, vec16, q, k, v, o, B, hq, hkv, S, st,
                                   scale, causal, window, s);
  return launch_d<float>(D, vec16, q, k, v, o, B, hq, hkv, S, st, scale,
                         causal, window, s);
}
