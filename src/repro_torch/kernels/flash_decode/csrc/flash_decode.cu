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
// q head h reads kv head h / (Hq / Hkv).
//
// What bounds it: memory.  One call reads K and V once,
// 2*B*Hkv*L*D*itemsize bytes, and does 4*B*Hq*L*D flops: a few flops per
// byte.  Reading each K/V row once takes a CTA that scores every q head of
// the row's GQA group; keeping the card's memory busy takes enough CTAs and
// enough tiles in flight; and the scoring must not be what limits the
// rate, which in fp32 SIMT it is (PERF.md, the flash_decode findings).  So:
//
//  * One CTA per (b, kv head, key split) scores the q heads of its GQA
//    group (or of a head chunk of it, when the group does not fit one CTA)
//    from one read of each K and V row.
//  * The key axis is split across the CTAs of a thread-block cluster (1 to
//    8 CTAs, chosen by the wrapper from L and B*Hkv so that the grid covers
//    the SMs).  Each CTA takes a contiguous run of key tiles.  The CTAs'
//    partial statistics merge through distributed shared memory, in rank
//    order: one launch per call, no workspace, no atomics, so a call is
//    bitwise reproducible.  An L that one CTA covers runs as a cluster of
//    one.
//  * K and V arrive tile by tile (kTileBytes of each) into a ring of
//    kStages shared-memory stages filled by a producer warp, which also
//    writes each tile's valid bytes beside it.  A stage's `full` mbarrier
//    completes when the tile has landed, its `empty` mbarrier when every
//    consumer warp is done with it, and only then is it refilled: up to
//    kStages tiles are in flight, and the consumer warps never wait for
//    one another inside the key loop.
//  * Scores are kept in log2 units: q . k is scaled by log2(e) / sqrt(D),
//    p = exp2(s - m), and m is written back in natural units.
//  * Masking: positions with valid == 0 score NEG_INF = -1e30 (not -inf, so
//    a row with no valid key stays finite and returns m == NEG_INF, as in
//    the reference); positions past L in the ragged last tile score -inf
//    and add exactly 0.  A split whose keys are all invalid has m = NEG_INF
//    and is cleared by exp2(NEG_INF - m) = 0 in the merge, as the single
//    pass clears such a run.
//
// Two routes, picked by the K/V dtype (the wrapper names it in the call):
//
//  * "mma" (bf16 K/V, every serving path; kernel
//    `flash_decode_stats_kernel`): 4 consumer warps each take 16 keys of a
//    tile and score them on the tensor cores with `mma.sync` m16n8k16: S
//    (q heads x keys) = Q K^T with the CTA's q heads as the 16 rows (bf16
//    products are exact in the fp32 accumulators; an fp32 q is split into
//    two bf16 halves), then acc^T (D x heads) += V^T P^T, with the fp32 p
//    split into two bf16 halves (p to about 2^-17; l sums the fp32 p).  The
//    S accumulators are laid out as the P^T operand needs them, so p never
//    leaves registers.  Tiles arrive through TMA (`cp.async.bulk.tensor`,
//    one tensor map each for K and V, encoded by the launcher through
//    cudaGetDriverEntryPoint: no -lcuda) in TMA's 128-byte swizzle (32-byte
//    at D = 16), so that `ldmatrix` reads 8 rows without bank conflicts;
//    rows past L arrive as zeros.
//  * "simt" (fp32 K/V; kernel `flash_decode_stats_kernel_simt`): 8
//    consumer warps in head_warps groups of HC q heads each, tiles through
//    `cp.async.bulk`.  A lane holds 16 bytes of a row and LG = D / 4 lanes
//    cover it; each lane group keeps its own online softmax for its warp's
//    heads, rescaled once per kSteps rows, in fp32 FMAs.
//
// C interface (bound with ctypes): `flash_decode_stats` launches on the given
// stream with cudaLaunchKernelEx and a cluster attribute and returns
// cudaGetLastError(); invalid shapes or launch shapes return
// cudaErrorInvalidValue without launching.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileBytes = 8192;    // bytes of K (and of V) per stage
constexpr int kStages = 4;
constexpr int kMaxTileRows = kTileBytes / 32;   // bf16 rows at D = 16
constexpr int kSmem = kStages * 2 * kTileBytes;
constexpr int kSwizzleAlign = 1024;     // a 128-byte swizzle's period
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMma = 0, kSimt = 1;  // route codes

// simt route: 8 consumer warps, kSteps rows per lane group between rescales
constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = (kSimtWarps + 1) * 32;
constexpr int kSteps = 2;
// mma route: 4 consumer warps, at most 16 q heads (the mma's rows) a CTA
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = (kMmaWarps + 1) * 32;
constexpr int kMmaHeads = 16;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// 4 fp32 values in one 16-byte load
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

// ---------------------------------------------------------------- PTX

// 2^x in one instruction (MUFU.EX2, 2 ulp; results below 2^-126 flush to
// 0, far under the 1e-4 the statistics are held to)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// a box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`; rows past the tensor's extent are zero-filled
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16 (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the high bf16 half of x and y and the bf16 of what is left
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// ---------------------------------------------------------------- merge

// The cluster's CTAs merge their statistics (r_m, r_l, r_acc: hpc heads x
// D, in each CTA's shared memory) in rank order; each CTA writes a share of
// the outputs, every remote load of an output issued before the first is
// used.  Called by every thread of every CTA after a cluster barrier.
template <int D>
__device__ __forceinline__ void cluster_merge(
    cg::cluster_group& cluster, float* r_m, float* r_l, float* r_acc,
    int hpc, int rank, int splits, int nthreads, size_t out_row,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out) {
  const int n_out = hpc * D;
  const int share = (n_out + splits - 1) / splits;
  for (int e = rank * share + threadIdx.x; e < min(n_out, (rank + 1) * share);
       e += nthreads) {
    const int hh = e / D;
    float mc[kMaxCluster], ac[kMaxCluster], lc[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < splits) {
        mc[c] = *cluster.map_shared_rank(r_m + hh, c);
        ac[c] = *cluster.map_shared_rank(r_acc + e, c);
        lc[c] = *cluster.map_shared_rank(r_l + hh, c);
      }
    }
    float mx = mc[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c)
      if (c < splits) mx = fmaxf(mx, mc[c]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < splits) {
        const float wt = exp2_fast(mc[c] - mx);
        a = fmaf(ac[c], wt, a);
        ls = fmaf(lc[c], wt, ls);
      }
    }
    const size_t o = out_row + hh;
    acc_out[o * D + e % D] = a;
    if (e % D == 0) {
      m_out[o] = mx == kNegInf ? kNegInf : mx * kLn2;
      l_out[o] = ls;
    }
  }
}

// ---------------------------------------------------------------- producer

// The producer warp's loop over this CTA's nt tiles (key rows from t0 * T):
// tile j goes to stage j % kStages once every consumer warp has released
// the stage (its `empty` mbarrier), through `copy_kv(j)`, with its valid
// bytes beside it in ok_s.  Those bytes are loaded into the warp's
// registers kStages tiles ahead, when the stage of tile j - kStages was
// filled, so their latency hides behind the consumers' work; each lane
// arrives on the stage's `full` mbarrier once its bytes are written.
template <int T, typename CopyKV>
__device__ __forceinline__ void produce(CopyKV copy_kv,
                                        const uint8_t* __restrict__ ok,
                                        int t0, int nt, int L,
                                        uint8_t (*ok_s)[kMaxTileRows],
                                        uint32_t full_s, uint32_t empty_s) {
  constexpr int kOk = (T + 31) / 32;          // valid bytes a lane
  const int lane = threadIdx.x % 32;
  uint8_t held[kStages][kOk];
  auto fetch = [&](int j, uint8_t (&dst)[kOk]) {
    const int row = (t0 + j) * T;
    const int rows = j < nt ? min(T, L - row) : 0;
#pragma unroll
    for (int i = 0; i < kOk; ++i) {
      const int r = lane + 32 * i;
      dst[i] = r < rows ? ok[row + r] : 0;
    }
  };
#pragma unroll
  for (int u = 0; u < kStages; ++u) fetch(u, held[u]);
  for (int base = 0; base < nt; base += kStages) {
#pragma unroll
    for (int u = 0; u < kStages; ++u) {   // stage u holds tile base + u
      const int j = base + u;
      if (j < nt) {
        if (j >= kStages)
          mbar_wait(empty_s + 8 * u,
                    static_cast<uint32_t>((j / kStages - 1) & 1));
        copy_kv(j);
#pragma unroll
        for (int i = 0; i < kOk; ++i)
          if (lane + 32 * i < T) ok_s[u][lane + 32 * i] = held[u][i];
        mbar_arrive(full_s + 8 * u);
        fetch(j + kStages, held[u]);
      }
    }
  }
}

// ---------------------------------------------------------------- mma

// The 16-byte chunk of a tile of T rows at (row r, chunk c), rows of CH
// chunks, as TMA's swizzle lays it out: rows of 128 bytes (D = 64, and each
// 64-column panel of D = 128) XOR the chunk with r % 8 (SWIZZLE_128B),
// rows of 32 bytes (D = 16) with bit 2 of r (SWIZZLE_32B).  So the 8 rows
// an ldmatrix reads at one logical chunk land in 8 different bank groups.
template <int CH, int T>
__device__ __forceinline__ int chunk_at(int r, int c) {
  if constexpr (CH >= 8)
    return (c / 8) * (T * 8) + r * 8 + ((c % 8) ^ (r & 7));
  else
    return r * CH + (c ^ ((r >> 2) & 1));           // CH == 2
}

// grid (splits, Hkv * head_chunks, B), cluster (splits, 1, 1); hpc q heads
// a CTA (NH = 8 or 16: the P^T operand's head tiles); K and V as tensor
// maps of (D, L, B * Hkv) with boxes of (min(D, 64), T, 1); qscale is
// log2(e) / sqrt(D)
template <typename TQ, int D, int NH>
__global__ void __launch_bounds__(kMmaThreads)
flash_decode_stats_kernel(const TQ* __restrict__ q,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ acc_out,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out, int hq, int hkv, int L,
                          int hpc, float qscale) {
  constexpr int kRowBytes = D * 2;
  constexpr int CH = kRowBytes / 16;          // 16-byte chunks a row
  constexpr int T = kTileBytes / kRowBytes;   // rows per tile
  constexpr int KS = D / 16;                  // k-steps of Q K^T, m-tiles of V^T
  constexpr int NT = NH / 8;                  // head tiles of P^T
  constexpr bool kSplitQ = sizeof(TQ) == 4;   // fp32 q as two bf16 halves
  constexpr int P = D < 64 ? D : 64;          // columns of a TMA box
  static_assert(T % 16 == 0 && T <= kMaxTileRows && (CH >= 8 || CH == 2),
                "a tile is whole 16-key groups in the swizzle's shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ uint8_t ok_s[kStages][kMaxTileRows];
  __shared__ float w_m[kMmaWarps][NH], w_l[kMmaWarps][NH];
  __shared__ float w_acc[kMmaWarps][NH][D];
  __shared__ float r_m[NH], r_l[NH];
  __shared__ float r_acc[NH][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int group = hq / hkv;
  const int chunks = group / hpc;
  const int kh = blockIdx.y / chunks;
  const int head_cta = kh * group + (blockIdx.y % chunks) * hpc;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int tiles = (L + T - 1) / T;
  const int t0 = static_cast<int>((long long)tiles * rank / splits);
  const int nt = static_cast<int>((long long)tiles * (rank + 1) / splits) - t0;

  // the swizzle is a function of the address: stages start on its period
  const uint32_t ring_s = (smem_u32(smem_raw) + kSwizzleAlign - 1)
                          & ~(uint32_t)(kSwizzleAlign - 1);
  const uint32_t full_s = smem_u32(full), empty_s = smem_u32(empty);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // lane 0's expect_tx (the boxes' bytes) and each lane's valid bytes
      mbar_init(full_s + 8 * s, 33);
      mbar_init(empty_s + 8 * s, kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kMmaWarps) {
    // producer: K and V through TMA, D / P boxes each, lane 0 arming the
    // stage's mbarrier with their bytes (rows past L arrive as zeros: p = 0
    // must meet 0, not stale bytes)
    const int slab = b * hkv + kh;
    auto copy_kv = [&](int j) {
      if (lane != 0) return;
      const int s = j % kStages;
      const int row0 = (t0 + j) * T;
      const uint32_t bar = full_s + 8 * s;
      const uint32_t ks = ring_s + s * 2 * kTileBytes;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < D / P; ++c) {
        tma_load_3d(ks + c * T * P * 2, &tk, bar, c * P, row0, slab);
        tma_load_3d(ks + kTileBytes + c * T * P * 2, &tv, bar, c * P, row0,
                    slab);
      }
    };
    produce<T>(copy_kv, valid + (size_t)b * L, t0, nt, L, ok_s, full_s,
               empty_s);
  } else {
    // consumers: warp w scores 16-key groups w, w + 4, ... of each tile
    const int gid = lane / 4, tid4 = lane % 4;

    // Q as the A operand, rows = the CTA's heads (gid, gid + 8), cols =
    // dims; heads past hpc are zero
    uint32_t qa[KS][4], qa_lo[kSplitQ ? KS : 1][4];
    {
      const TQ* q0 = q + ((size_t)b * hq + head_cta) * D;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int h = gid + 8 * (x & 1);
          const int d = kk * 16 + 2 * tid4 + 8 * (x >> 1);
          float f0 = 0.f, f1 = 0.f;
          if (h < hpc) {
            f0 = to_float(q0[h * D + d]);
            f1 = to_float(q0[h * D + d + 1]);
          }
          if constexpr (kSplitQ) {
            split_bf16(f0, f1, qa[kk][x], qa_lo[kk][x]);
          } else {
            qa[kk][x] = pack_bf16(f0, f1);     // exact: q is bf16
          }
        }
      }
    }

    // per thread: rows gid and gid + 8 of S (heads), keys 2 tid4, +1 of
    // each 8-key half; acc^T rows = dims, cols = heads 2 tid4, +1
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[KS][NT][4];
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mt][n][x] = 0.f;

    // ldmatrix: lane l gives row l % 8 of matrix l / 8 = (keys +8 if
    // l / 8 >= 2, chunk +1 if l / 8 is odd)
    const int ld_row = lane % 8 + 8 * (lane / 16);
    const int ld_chunk = (lane / 8) % 2;

    for (int j = 0; j < nt; ++j) {
      const int s = j % kStages;
      mbar_wait(full_s + 8 * s, static_cast<uint32_t>((j / kStages) & 1));
      const uint32_t ks = ring_s + s * 2 * kTileBytes;
      const uint32_t vs = ks + kTileBytes;
      const int rows = min(T, L - (t0 + j) * T);
      for (int g = warp; g < T / 16; g += kMmaWarps) {
        const int key0 = g * 16;
        // 1. S = Q K^T over the group's two 8-key halves
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[4];
          ldsm_x4(ks + chunk_at<CH, T>(key0 + ld_row, 2 * kk + ld_chunk) * 16,
                  kb);
          mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
          mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
          if constexpr (kSplitQ) {
            mma_bf16(sc[0], qa_lo[kk], kb[0], kb[1]);
            mma_bf16(sc[1], qa_lo[kk], kb[2], kb[3]);
          }
        }
        // 2. scale, mask, and each head row's online softmax
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = key0 + 8 * half + 2 * tid4 + e;
            const bool in = r < rows;
            const bool admit = in && ok_s[s][r];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& x = sc[half][2 * hr + e];
              x = admit ? x * qscale : (in ? kNegInf : -INFINITY);
            }
          }
        }
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (hr == 1 && NH == 8) {           // rows gid + 8: no head there
            alpha[1] = 1.f;
            continue;
          }
          float mx = fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                           fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, m[hr]);
          alpha[hr] = exp2_fast(m[hr] - mx);
          m[hr] = mx;
          float ps = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[half][2 * hr + e];
              x = exp2_fast(x - mx);
              ps += x;
            }
          }
          l[hr] = fmaf(l[hr], alpha[hr], ps);
        }
        // 3. rescale acc^T: column head 2 tid4 (+1) of head tile n takes
        //    the alpha of row gid = 2 tid4 (+1) of S
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float a0 = __shfl_sync(0xffffffffu, alpha[n], 8 * tid4);
          const float a1 = __shfl_sync(0xffffffffu, alpha[n], 8 * tid4 + 4);
#pragma unroll
          for (int mt = 0; mt < KS; ++mt) {
            acc[mt][n][0] *= a0;
            acc[mt][n][1] *= a1;
            acc[mt][n][2] *= a0;
            acc[mt][n][3] *= a1;
          }
        }
        // 4. acc^T += V^T P^T: P^T's operand is S's accumulator layout
        uint32_t pb_hi[NT][2], pb_lo[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            split_bf16(sc[half][2 * n], sc[half][2 * n + 1], pb_hi[n][half],
                       pb_lo[n][half]);
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          uint32_t va[4];
          ldsm_x4_trans(
              vs + chunk_at<CH, T>(key0 + ld_row, 2 * mt + ld_chunk) * 16, va);
          // matrices: (keys 0-7, dims 0-7), (keys 0-7, dims 8-15),
          // (keys 8-15, dims 0-7), (keys 8-15, dims 8-15), transposed:
          // a0..a3 of V^T's m16k16 tile
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma_bf16(acc[mt][n], va, pb_hi[n][0], pb_hi[n][1]);
            mma_bf16(acc[mt][n], va, pb_lo[n][0], pb_lo[n][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_s + 8 * s);   // stage s is free
    }

    // the warp's statistics: l summed over the 4 lanes of a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      const int h = gid + 8 * hr;
      if (tid4 == 0 && h < NH) {
        w_m[warp][h] = m[hr];
        w_l[warp][h] = l[hr];
      }
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          w_acc[warp][8 * n + 2 * tid4 + (x & 1)][16 * mt + gid + 8 * (x >> 1)]
              = acc[mt][n][x];
  }
  __syncthreads();

  // 5. merge the warps, in warp order (a warp that scored no key holds
  //    m = NEG_INF, l = 0, acc = 0)
  for (int e = tid; e < hpc * D; e += kMmaThreads) {
    const int h = e / D, d = e % D;
    float mx = w_m[0][h];
    for (int w = 1; w < kMmaWarps; ++w) mx = fmaxf(mx, w_m[w][h]);
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) {
      const float wt = exp2_fast(w_m[w][h] - mx);
      a = fmaf(w_acc[w][h][d], wt, a);
      ls = fmaf(w_l[w][h], wt, ls);
    }
    r_acc[h][d] = a;
    if (d == 0) {
      r_m[h] = mx;
      r_l[h] = ls;
    }
  }
  cluster.sync();                   // every CTA's statistics are written

  // 6. the cluster's CTAs merge, in rank order
  cluster_merge<D>(cluster, r_m, r_l, &r_acc[0][0], hpc, rank, splits,
                   kMmaThreads, (size_t)b * hq + head_cta, acc_out, m_out,
                   l_out);
  cluster.sync();                   // no CTA leaves while others read it
}

// ---------------------------------------------------------------- simt

// grid (splits, Hkv * head_chunks, B), cluster (splits, 1, 1); qscale is
// log2(e) / sqrt(D)
template <typename TQ, int D, int HC>
__global__ void __launch_bounds__(kSimtThreads)
flash_decode_stats_kernel_simt(const TQ* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const uint8_t* __restrict__ valid,
                               float* __restrict__ acc_out,
                               float* __restrict__ m_out,
                               float* __restrict__ l_out, int hq, int hkv,
                               int L, int head_warps, float qscale) {
  using TKV = float;
  constexpr int kWarps = kSimtWarps;
  constexpr int kThreads = kSimtThreads;
  constexpr int VEC = 4;                      // fp32 values in 16 bytes
  constexpr int LG = D / VEC;                 // lanes per key row
  constexpr int RPW = 32 / LG;                // rows per warp per pass
  constexpr int kRowBytes = D * (int)sizeof(TKV);
  constexpr int T = kTileBytes / kRowBytes;   // rows per tile
  static_assert(D % VEC == 0 && LG <= 32 && 32 % LG == 0,
                "a key row must split evenly over a power-of-two lane group");
  static_assert(T == kSteps * kWarps * RPW && T <= kMaxTileRows,
                "with one head group, the 8 warps' lane groups cover a tile "
                "in kSteps passes");

  extern __shared__ __align__(128) unsigned char ring[];
  // per stage: K/V landed and the tile's valid bytes written (full), and
  // every consumer warp done with it (empty)
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ uint8_t ok_s[kStages][kMaxTileRows];
  __shared__ float w_m[kWarps][HC], w_l[kWarps][HC];
  __shared__ float w_acc[kWarps][HC][D];
  // the CTA's statistics, read by every CTA of the cluster
  __shared__ float r_m[kWarps * HC], r_l[kWarps * HC];
  __shared__ float r_acc[kWarps * HC][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int group = hq / hkv;
  const int hpc = HC * head_warps;            // q heads of this CTA
  const int chunks = group / hpc;
  const int kh = blockIdx.y / chunks;
  const int head_cta = kh * group + (blockIdx.y % chunks) * hpc;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // this CTA's run of key tiles
  const int tiles = (L + T - 1) / T;
  const int t0 = static_cast<int>((long long)tiles * rank / splits);
  const int nt = static_cast<int>((long long)tiles * (rank + 1) / splits) - t0;

  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full_s = smem_u32(full), empty_s = smem_u32(empty);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // lane 0's expect_tx (the bulk copies' bytes) and each lane's valid
      // bytes
      mbar_init(full_s + 8 * s, 33);
      mbar_init(empty_s + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: K and V through one bulk copy each, lane 0 arming the
    // stage's mbarrier with their bytes
    const size_t kv_row0 = ((size_t)b * hkv + kh) * (size_t)L;
    const unsigned char* kbytes =
        reinterpret_cast<const unsigned char*>(k + kv_row0 * D);
    const unsigned char* vbytes =
        reinterpret_cast<const unsigned char*>(v + kv_row0 * D);
    auto copy_kv = [&](int j) {
      if (lane != 0) return;
      const int s = j % kStages;
      const int row = (t0 + j) * T;
      const uint32_t bytes =
          static_cast<uint32_t>(min(T, L - row)) * kRowBytes;
      const uint32_t bar = full_s + 8 * s;
      const uint32_t dst = ring_s + s * 2 * kTileBytes;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(bar, 2 * bytes);
      bulk_load(dst, kbytes + (size_t)row * kRowBytes, bytes, bar);
      bulk_load(dst + kTileBytes, vbytes + (size_t)row * kRowBytes, bytes,
                bar);
    };
    produce<T>(copy_kv, valid + (size_t)b * L, t0, nt, L, ok_s, full_s,
               empty_s);
  } else {
    // consumers
    const int seg = lane % LG;                // 16-byte segment of the row
    const int lgi = lane / LG;                // lane group in the warp
    const int row_warps = kWarps / head_warps;  // warps sharing a head group
    const int wh = warp / row_warps;          // head group of this warp
    const int wr = warp % row_warps;          // row group of this warp

    // this warp's HC q heads: the lane's segment, scaled into log2 units
    float qv[HC][VEC];
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      const TQ* qp = q + ((size_t)b * hq + head_cta + wh * HC + h) * D
                     + seg * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[h][i] = to_float(qp[i]) * qscale;
    }

    float m[HC], l[HC], acc[HC][VEC];
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[h][i] = 0.f;
    }

    const int pass_rows = row_warps * RPW;    // rows of one pass of a warp
    const int steps = T / (kSteps * pass_rows);
    for (int j = 0; j < nt; ++j) {
      const int s = j % kStages;
      mbar_wait(full_s + 8 * s, static_cast<uint32_t>((j / kStages) & 1));
      const TKV* ks = reinterpret_cast<const TKV*>(ring + s * 2 * kTileBytes);
      const TKV* vs = reinterpret_cast<const TKV*>(ring + s * 2 * kTileBytes
                                                   + kTileBytes);
      const int rows = min(T, L - (t0 + j) * T);
      for (int st = 0; st < steps; ++st) {
        // 1. kSteps rows' scores for each head; every lane of the warp
        //    takes part in the shuffles, rows past the tile's end included
        float sc[HC][kSteps];
#pragma unroll
        for (int p = 0; p < kSteps; ++p) {
          const int r = (st * kSteps + p) * pass_rows + wr * RPW + lgi;
          float kf[VEC];
          load4(ks + r * D + seg * VEC, kf);
          float part[HC];
#pragma unroll
          for (int h = 0; h < HC; ++h) {
            part[h] = 0.f;
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              part[h] = fmaf(qv[h][i], kf[i], part[h]);
          }
#pragma unroll
          for (int o = LG / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int h = 0; h < HC; ++h)
              part[h] += __shfl_xor_sync(0xffffffffu, part[h], o);
          }
          const bool in = r < rows;
          const bool admit = in && ok_s[s][r];
#pragma unroll
          for (int h = 0; h < HC; ++h)
            sc[h][p] = admit ? part[h] : (in ? kNegInf : -INFINITY);
        }
        // 2. the lane group's running max, rescale factor and p
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          float mx = m[h];
#pragma unroll
          for (int p = 0; p < kSteps; ++p) mx = fmaxf(mx, sc[h][p]);
          const float alpha = exp2_fast(m[h] - mx);
          m[h] = mx;
          float ps = 0.f;
#pragma unroll
          for (int p = 0; p < kSteps; ++p) {
            sc[h][p] = exp2_fast(sc[h][p] - mx);
            ps += sc[h][p];
          }
          l[h] = fmaf(l[h], alpha, ps);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[h][i] *= alpha;
        }
        // 3. acc += p v over the rows that exist (a stage's rows past the
        //    tile's end hold stale bytes)
#pragma unroll
        for (int p = 0; p < kSteps; ++p) {
          const int r = (st * kSteps + p) * pass_rows + wr * RPW + lgi;
          if (r < rows) {
            float vf[VEC];
            load4(vs + r * D + seg * VEC, vf);
#pragma unroll
            for (int h = 0; h < HC; ++h)
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                acc[h][i] = fmaf(sc[h][p], vf[i], acc[h][i]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_s + 8 * s);   // stage s is free
    }

    // 4. merge the warp's lane groups (lane group 0 keeps the result)
#pragma unroll
    for (int o = LG; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], o);
        const float mx = fmaxf(m[h], mo);
        const float wa = exp2_fast(m[h] - mx), wb = exp2_fast(mo - mx);
        m[h] = mx;
        l[h] = l[h] * wa + lo * wb;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[h][i], o);
          acc[h][i] = acc[h][i] * wa + ao * wb;
        }
      }
    }
    if (lgi == 0) {
#pragma unroll
      for (int h = 0; h < HC; ++h) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          w_acc[warp][h][seg * VEC + i] = acc[h][i];
        if (seg == 0) {
          w_m[warp][h] = m[h];
          w_l[warp][h] = l[h];
        }
      }
    }
  }
  __syncthreads();

  // 5. merge the row groups of each head group, in warp order
  const int row_warps = kWarps / head_warps;
  for (int e = tid; e < hpc * D; e += kThreads) {
    const int hh = e / D, d = e % D;
    const int w0 = (hh / HC) * row_warps, h = hh % HC;
    float mx = w_m[w0][h];
    for (int r = 1; r < row_warps; ++r) mx = fmaxf(mx, w_m[w0 + r][h]);
    float a = 0.f, ls = 0.f;
    for (int r = 0; r < row_warps; ++r) {
      const float wt = exp2_fast(w_m[w0 + r][h] - mx);
      a = fmaf(w_acc[w0 + r][h][d], wt, a);
      ls = fmaf(w_l[w0 + r][h], wt, ls);
    }
    r_acc[hh][d] = a;
    if (d == 0) {
      r_m[hh] = mx;
      r_l[hh] = ls;
    }
  }
  cluster.sync();                   // every CTA's statistics are written

  // 6. the cluster's CTAs merge, in rank order
  cluster_merge<D>(cluster, r_m, r_l, &r_acc[0][0], hpc, rank, splits,
                   kThreads, (size_t)b * hq + head_cta, acc_out, m_out,
                   l_out);
  cluster.sync();                   // no CTA leaves while others read it
}

// ---------------------------------------------------------------- host

// Launches `kernel` on clusters of grid.x CTAs along x, with `smem` bytes
// of dynamic shared memory; on its first call on a device it opts the
// kernel in to them (above 48 KB), which then holds, so that later launches
// can be captured in a CUDA graph.
template <typename... P, typename... A>
cudaError_t launch_on_cluster(void (*kernel)(P...), bool (&ready)[kMaxDevices],
                              dim3 grid, int threads, int smem,
                              cudaStream_t stream, A... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

struct Call {
  const void *q, *k, *v, *valid;
  void *acc, *m, *l;
  int B, hq, hkv, L, heads_per_warp, head_warps, splits;
  float qscale;
  cudaStream_t stream;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// K or V, `slabs` = B * Hkv runs of L rows of D bf16, as a 3-D map (D, L,
// slabs) with boxes of (min(D, 64), T, 1) in the swizzle chunk_at reads
template <int D>
CUresult kv_map(CUtensorMap* map, const void* ptr, int L, int slabs) {
  constexpr int P = D < 64 ? D : 64;
  constexpr int T = kTileBytes / (D * 2);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)P, (cuuint32_t)T, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   P * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_32B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename TQ, int D, int NH>
cudaError_t launch_mma(const Call& c) {
  static bool ready[kMaxDevices] = {};
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tk, tv;
  if (kv_map<D>(&tk, c.k, c.L, c.B * c.hkv) != CUDA_SUCCESS ||
      kv_map<D>(&tv, c.v, c.L, c.B * c.hkv) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int chunks = c.hq / c.hkv / c.heads_per_warp;
  return launch_on_cluster(
      flash_decode_stats_kernel<TQ, D, NH>, ready,
      dim3(c.splits, c.hkv * chunks, c.B), kMmaThreads,
      kSmem + kSwizzleAlign, c.stream, static_cast<const TQ*>(c.q), tk, tv,
      static_cast<const uint8_t*>(c.valid),
      static_cast<float*>(c.acc), static_cast<float*>(c.m),
      static_cast<float*>(c.l), c.hq, c.hkv, c.L, c.heads_per_warp,
      c.qscale);
}

template <typename TQ, int D, int HC>
cudaError_t launch_simt(const Call& c) {
  static bool ready[kMaxDevices] = {};
  const int chunks = c.hq / c.hkv / (HC * c.head_warps);
  return launch_on_cluster(
      flash_decode_stats_kernel_simt<TQ, D, HC>, ready,
      dim3(c.splits, c.hkv * chunks, c.B), kSimtThreads, kSmem, c.stream,
      static_cast<const TQ*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const uint8_t*>(c.valid),
      static_cast<float*>(c.acc), static_cast<float*>(c.m),
      static_cast<float*>(c.l), c.hq, c.hkv, c.L, c.head_warps, c.qscale);
}

template <typename TQ, int D>
cudaError_t launch_route(int route, const Call& c) {
  if (route == kMma)
    return c.heads_per_warp <= 8 ? launch_mma<TQ, D, 8>(c)
                                 : launch_mma<TQ, D, 16>(c);
  switch (c.heads_per_warp) {
    case 1: return launch_simt<TQ, D, 1>(c);
    case 2: return launch_simt<TQ, D, 2>(c);
    case 4: return launch_simt<TQ, D, 4>(c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_d(int D, int route, const Call& c) {
  switch (D) {
    case 16: return launch_route<TQ, 16>(route, c);
    case 64: return launch_route<TQ, 64>(route, c);
    case 128: return launch_route<TQ, 128>(route, c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,1,D) and k/v (B,Hkv,L,D) contiguous, k/v 16-byte aligned; valid
// (B,L) uint8; acc/m/l fp32 outputs.  q_bf16 / kv_bf16: 1 for bfloat16, 0
// for float32.  The launch shape, from the wrapper: route 0 ("mma") takes
// bf16 K/V, heads_per_warp q heads a CTA (1 to 16; every consumer warp
// scores all of them) and head_warps 1; route 1 ("simt") takes fp32 K/V,
// heads_per_warp in {1, 2, 4} and head_warps in {1, 2, 4, 8}.  Their
// product divides Hq / Hkv.  splits, the cluster's CTAs along the key
// axis, is in [1, 8] and no more than the key axis has tiles.  Returns a
// cudaError_t.
extern "C" int flash_decode_stats(const void* q, const void* k, const void* v,
                                  const void* valid, void* acc, void* m,
                                  void* l, int B, int hq, int hkv, int L,
                                  int D, int q_bf16, int kv_bf16, float scale,
                                  int route, int heads_per_warp,
                                  int head_warps, int splits, void* stream) {
  if (B < 1 || hq < 1 || hkv < 1 || L < 1 || hq % hkv || B > 65535 ||
      splits < 1 || splits > kMaxCluster || heads_per_warp < 1 ||
      head_warps < 1)
    return cudaErrorInvalidValue;
  if (D != 16 && D != 64 && D != 128) return cudaErrorInvalidValue;
  const int rows = kTileBytes / (D * (kv_bf16 ? 2 : 4));
  if (splits > (L + rows - 1) / rows) return cudaErrorInvalidValue;
  const int group = hq / hkv;
  if (group % (heads_per_warp * head_warps) ||
      (long long)hkv * (group / (heads_per_warp * head_warps)) > 65535)
    return cudaErrorInvalidValue;
  if (route == kMma) {
    if (!kv_bf16 || head_warps != 1 || heads_per_warp > kMmaHeads)
      return cudaErrorInvalidValue;
  } else if (route == kSimt) {
    if (kv_bf16 || (head_warps & (head_warps - 1)) || head_warps > 8)
      return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  const Call c{q, k, v, valid, acc, m, l, B, hq, hkv, L, heads_per_warp,
               head_warps, splits, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return q_bf16 ? launch_d<bf16>(D, route, c) : launch_d<float>(D, route, c);
}

// The kernel's shape, for the wrapper's launch_shape to check against its
// own copy: out[0] bytes of K (and of V) per tile, out[1] q heads a CTA of
// the mma route scores, out[2] the largest cluster.
extern "C" void flash_decode_shape(int* out) {
  out[0] = kTileBytes;
  out[1] = kMmaHeads;
  out[2] = kMaxCluster;
}
