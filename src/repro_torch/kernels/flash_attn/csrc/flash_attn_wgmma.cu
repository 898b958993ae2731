// Blockwise (flash) attention forward for bf16 on Hopper (sm_90a): the
// tensor-core route of `flash_attention`.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (body `_attn_kernel`)
// in src/repro/kernels/flash_attn/flash_attn.py for bf16 q, k, v.  For q
// (B,Hq,S,D) and k, v (B,Hkv,S,D) it returns, per (batch, q head, query row),
//
//   out = sum_j p_j v_j / max(sum_j p_j, 1e-30),   p_j = exp(s_j - max_j s_j),
//   s_j = (q . k_j) / sqrt(D) where the mask admits key j, else -1e30,
//
// with the mask `k_pos <= q_pos` (causal) and `k_pos > q_pos - window`
// (optional sliding window), positions numbered from 0 on both axes; q head
// h reads kv head h / (Hq / Hkv).  The softmax is online over key tiles in
// fp32, as in the TPU kernel; the output is bf16.  fp32 inputs, and bf16
// layouts TMA cannot take, go to the TF32 mma kernel of flash_attn.cu (the
// wrapper chooses before it launches).
//
// What bounds it: operations.  The function's work is 4*D flops per (query,
// key) pair the mask admits (q.k and p.v, a multiply and an add each):
// 4*B*Hq*D*S*(S+1)/2 causal, 4.398e12 at the serving prefill's layer shape
// (B=1, Hq=32, S=32768, D=64), 4.447 ms at the H100's 989 TFLOP/s dense
// bf16, against 0.34 GB of q, k, v and o (0.1 ms at 3.35 TB/s).  The design
// follows from that:
//
//  * Tensor cores.  S = Q.K^T is a `wgmma` m64nBKk16 bf16 -> fp32 with Q and
//    K read from shared memory.  q and k are bf16, so each product is exact
//    and only the order of the sums differs from the fp32 reference.
//  * P.V with p kept to about 2^-17 relative.  The reference multiplies
//    fp32 p (2^-24) by v widened to fp32.  Rounding p once to bf16, as
//    FlashAttention-2 and PyTorch's fused attention do, keeps it to 2^-9;
//    with that, chip_smoke.py's S=4096 prefill check (bf16 logits within
//    1.25x the misses of the bf16 blockwise prefill) failed one seed of
//    ten.  So each fp32 p is split into p_hi = bf16(p) and p_lo =
//    bf16(p - p_hi), and P.V is two register-sourced `wgmma` (A = the P
//    fragments in registers, B = the V tile in shared memory, MN-major)
//    into the same fp32 O.  p_hi + p_lo is not the reference's fp32 p: it
//    drops p's bits below about 2^-17 of p.  The split doubles P.V: the
//    kernel executes 1.5x the function's tensor-core work (6.6e12 flops at
//    the prefill shape), a cost the bound does not count.  l sums the fp32
//    p, as the reference does.
//  * Fed by TMA.  The launcher encodes one tensor map each for Q, K, V and
//    O with their real strides (cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint: no -lcuda).  Q is loaded once per block; K and
//    V tiles go through a ring of kStages shared-memory stages with full and
//    empty mbarriers, filled by one producer thread of a warpgroup that
//    gives its registers to the consumers (setmaxnreg).  TMA's zero fill of
//    rows past S replaces hand masking of the ragged tile's loads; keys at
//    or past S are still masked out of the softmax.
//  * Overlap.  Two consumer warpgroups of 64 query rows each (a 128-row q
//    tile) share every K/V tile.  Within a warpgroup, tile j's Q.K^T and
//    tile j-1's P.V are issued together, so that tile j's softmax runs
//    while P.V is in flight; between the two warpgroups a pair of named
//    barriers orders the issues (ping-pong), so one warpgroup's softmax
//    runs under the other's matrix products.  The scale is folded into
//    exp2 with log2(e).  Masks are applied only on tiles that cross the
//    diagonal, the window's edge or S; tiles wholly in the future or wholly
//    out of the window are skipped, as in the TPU kernel.
//  * Masked scores are -1e30, the TPU kernel's value, and the running max
//    starts there too.  A row whose keys so far are all masked (a window
//    row meeting a key tile wholly before its window) then has max -1e30
//    and p = 1 for those keys, as in the TPU kernel, until its first
//    admitted key makes the rescale factor exp(-1e30 - max) = 0.  The
//    exponent's fused multiply-add would leave a residual near 1e23 of
//    -1e30*scale - round(-1e30*scale), so such a row's p is set to 1
//    directly (only tiles that need a mask can hold one), and the rescale
//    factor subtracts two rounded products (__fmul_rn, not fused).
//  * Scheduling.  One block per (q tile, head, batch), the last (longest)
//    q tiles first, and the query heads of one kv head next to each other
//    in launch order so that they find its K/V tiles in L2.  No atomics and
//    a fixed order of every sum: two runs give the same bits.
//  * Epilogue.  O / max(l, 1e-30) -> bf16 into shared memory, then a TMA
//    store of each warpgroup's 64 rows, which clips rows past S.
//
// C interface (bound with ctypes): `flash_attention_wgmma_fwd` launches on
// the given stream and returns cudaGetLastError(); invalid shapes return
// cudaErrorInvalidValue without launching, and a tensor map the driver
// refuses returns 1000 + its CUresult.  Strides are in elements; D must be
// contiguous, base addresses and the other strides positive multiples of
// 16 bytes (the wrapper routes other layouts to flash_attn.cu); the output
// is (B,Hq,S,D) contiguous.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // query rows per block
constexpr int kWG = 128;            // threads per warpgroup
constexpr int kThreads = 3 * kWG;   // the producer and two consumers
constexpr int kStages = 3;          // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;    // the TPU kernel's masked score
constexpr int kMaxDevices = 64;

template <int D>
struct Cfg {
  // keys per tile: S (BK/2), O (D/2) and both halves of P (BK/4 each)
  // must fit a consumer thread's 240 registers
  static constexpr int BK = D <= 64 ? 128 : 64;
  static constexpr int PANEL = D < 64 ? D : 64;    // columns per TMA box
  static constexpr int NPANEL = D / PANEL;
  static constexpr int RB = PANEL * 2;             // bytes per panel row
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int O_BYTES = kBQ * D * 2;      // both warpgroups' O
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int O_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = O_OFF + O_BYTES;
  // q_full, then k_full, v_full and empty per stage; 1024 of alignment slack
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
  // the wgmma descriptor's layout type of the panels' swizzle
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static_assert(RB == 32 || RB == 64 || RB == 128, "swizzle width");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0 &&
                (BK * RB) % 1024 == 0, "panels must keep 1024 B alignment");
};

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait that orders them
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void hold(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16 B units) and the swizzle's layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(i) ACC4(i), ACC4(i + 4)
#define ACC16(i) ACC8(i), ACC8(i + 8)
#define ACC32(i) ACC16(i), ACC16(i + 16)

// d (+)= A.B^T, A (64 x 16) and B (N x 16) K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(0), ACC32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, A (64 x 16 bf16) in registers, B (16 x N) MN-major in shared
// memory (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n"
      "}\n"
      : ACC32(0), ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC4
#undef ACC8
#undef ACC16
#undef ACC32

// ---------------------------------------------------------------- kernel

// One consumer warpgroup's view of its 64 query rows.  Accumulator element
// i of a wgmma m64nN tile sits at row warp*16 + lane/4 + 8*((i/2)%2) and
// column 8*(i/4) + 2*(lane%4) + i%2; the A fragments of P.V take the same
// positions, so S's registers become P's without moving between threads.
template <int D>
struct Consumer {
  using C = Cfg<D>;
  static constexpr int BK = C::BK;
  static constexpr int NS = BK / 2;      // S registers per thread
  static constexpr int NO = D / 2;       // O registers per thread
  static constexpr int KS = BK / 16;     // P.V k-steps per tile

  float s[NS];
  float o[NO];
  uint32_t p_hi[KS][4];
  uint32_t p_lo[KS][4];
  float m[2], l[2];

  __device__ __forceinline__ void qk(uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // k-step kk: panel kk*16 / PANEL, 32 bytes per step within its rows
      const int panel = kk * 16 / C::PANEL;
      const uint32_t off = (kk * 16 % C::PANEL) * 2;
      const uint32_t qa = q_addr + panel * kBQ * C::RB + off;
      const uint32_t ka = k_addr + panel * BK * C::RB + off;
      wgmma_ss<BK>(s, make_desc(qa, 16, 8 * C::RB, C::LAYOUT),
                   make_desc(ka, 16, 8 * C::RB, C::LAYOUT), kk > 0);
    }
  }

  __device__ __forceinline__ void pv(const uint32_t (&p)[KS][4],
                                     uint32_t v_addr) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<D>(o, p[kk],
                  make_desc(v_addr + kk * 16 * C::RB, BK * C::RB, 8 * C::RB,
                            C::LAYOUT));
  }

  // masks (where `masked`), updates m and l and leaves p in s; sets alpha
  // to the factor that takes O from the old running max to the new one
  __device__ __forceinline__ void softmax(bool masked, int k0, int row0,
                                          int col, int S, int causal,
                                          int window, float sl2,
                                          float (&alpha)[2]) {
    if (masked) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = k0 + 8 * (i / 4) + col + (i % 2);
        const int qp = row0 + 8 * ((i / 2) % 2);
        bool ok = key < S;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && key > qp - window;
        if (!ok) s[i] = kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // rounded products: exactly 1 while the max stays at -1e30
      ms[r] = __fmul_rn(mx[r], sl2);
      alpha[r] = ex2(__fsub_rn(__fmul_rn(m[r], sl2), ms[r]));
      m[r] = mx[r];
    }
    if (masked) {
      // a row whose keys so far are all masked: every score of this tile
      // is -1e30 = its max, so p = exp(0) = 1, as in the TPU kernel
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (mx[r] == kNegInf) ms[r] = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (mx[(i / 2) % 2] == kNegInf) s[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i / 2) % 2;
      s[i] = ex2(fmaf(s[i], sl2, -ms[r]));
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
  }

  // p -> the bf16 A fragments p_hi + p_lo of P.V
  __device__ __forceinline__ void split_p() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float x0 = s[8 * kk + 2 * f], x1 = s[8 * kk + 2 * f + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        p_hi[kk][f] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][f] = *reinterpret_cast<const uint32_t*>(&lo);
      }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, int S,
                            int hq, int group, int batch, int nq, int causal,
                            int window, float sl2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t bar_q = base + C::BAR_OFF;
  auto k_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar_q + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bar_q + 8 * (1 + 2 * kStages + st); };

  // heads fastest, then batch, then q tiles from the last (longest)
  int idx = blockIdx.x;
  const int h = idx % hq;
  idx /= hq;
  const int b = idx % batch;
  const int qt = nq - 1 - idx / batch;
  const int q0 = qt * kBQ;
  const int kh = h / group;

  // the key tiles the TPU kernel runs for this q tile: not wholly in the
  // future, not wholly out of the window
  const int nk = (S + BK - 1) / BK;
  const int kt_end = causal ? min(nk, (q0 + kBQ - 1) / BK + 1) : nk;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 2 - BK;
    if (lo > 0) kt_begin = (lo + BK - 1) / BK;
  }
  const int n = kt_end - kt_begin;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 8);       // each consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < kWG) {
    // ---------------- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NPANEL; ++p)
        tma_load(base + C::Q_OFF + p * kBQ * C::RB, &tq, bar_q, p * C::PANEL,
                 q0, h, b);
      for (int j = 0; j < n; ++j) {
        const int st = j % kStages;
        mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
        const int k0 = (kt_begin + j) * BK;
        mbar_expect_tx(k_full(st), C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NPANEL; ++p)
          tma_load(base + C::K_OFF + st * C::KV_BYTES + p * BK * C::RB, &tk,
                   k_full(st), p * C::PANEL, k0, kh, b);
        mbar_expect_tx(v_full(st), C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NPANEL; ++p)
          tma_load(base + C::V_OFF + st * C::KV_BYTES + p * BK * C::RB, &tv,
                   v_full(st), p * C::PANEL, k0, kh, b);
      }
    }
  } else {
    // ---------------- consumers: warpgroup w owns q rows 64w .. 64w + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int w = tid / kWG - 1;
    const int t = tid % kWG;
    const int warp = t / 32, lane = t % 32;
    const int rows = q0 + 64 * w;           // this warpgroup's first row
    const int row0 = rows + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    const int mine = 1 + w, other = 2 - w;  // named barriers: whose turn
    const uint32_t q_addr = base + C::Q_OFF + 64 * w * C::RB;

    Consumer<D> c;
#pragma unroll
    for (int i = 0; i < Consumer<D>::NO; ++i) c.o[i] = 0.f;
    c.m[0] = c.m[1] = kNegInf;
    c.l[0] = c.l[1] = 0.f;
    float alpha[2];

    auto masked = [&](int k0) {
      bool need = k0 + BK > S;
      if (causal) need = need || k0 + BK - 1 > rows;
      if (window > 0) need = need || k0 <= rows + 63 - window;
      return need;
    };
    auto k_addr = [&](int st) { return base + C::K_OFF + st * C::KV_BYTES; };
    auto v_addr = [&](int st) { return base + C::V_OFF + st * C::KV_BYTES; };

    if (w == 1) bar_arrive(1, 2 * kWG);     // warpgroup 0 issues first
    mbar_wait(bar_q, 0);

    // the first key tile: its Q.K^T alone
    mbar_wait(k_full(0), 0);
    bar_sync(mine, 2 * kWG);
    hold(c.s);
    wg_fence();
    c.qk(q_addr, k_addr(0));
    wg_commit();
    bar_arrive(other, 2 * kWG);
    wg_wait<0>();
    hold(c.s);
    c.softmax(masked(kt_begin * BK), kt_begin * BK, row0, col, S, causal,
              window, sl2, alpha);
    c.split_p();

    // tile j's Q.K^T with tile j-1's P.V, then tile j's softmax under P.V
    for (int j = 1; j < n; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(k_full(st), (j / kStages) & 1);
      mbar_wait(v_full(prev), ((j - 1) / kStages) & 1);
      bar_sync(mine, 2 * kWG);
      hold(c.s);
      hold(c.o);
      hold(c.p_hi);
      hold(c.p_lo);
      wg_fence();
      c.qk(q_addr, k_addr(st));
      wg_commit();
      c.pv(c.p_hi, v_addr(prev));
      c.pv(c.p_lo, v_addr(prev));
      wg_commit();
      bar_arrive(other, 2 * kWG);
      wg_wait<1>();
      hold(c.s);
      const int k0 = (kt_begin + j) * BK;
      c.softmax(masked(k0), k0, row0, col, S, causal, window, sl2, alpha);
      wg_wait<0>();
      hold(c.o);
      hold(c.p_hi);
      hold(c.p_lo);
      if (lane == 0) mbar_arrive(empty(prev));
      c.rescale(alpha);
      c.split_p();
    }

    // the last tile's P.V
    const int last = (n - 1) % kStages;
    mbar_wait(v_full(last), ((n - 1) / kStages) & 1);
    bar_sync(mine, 2 * kWG);
    hold(c.o);
    hold(c.p_hi);
    hold(c.p_lo);
    wg_fence();
    c.pv(c.p_hi, v_addr(last));
    c.pv(c.p_lo, v_addr(last));
    wg_commit();
    if (w == 0) bar_arrive(other, 2 * kWG);   // warpgroup 1 syncs once more
    wg_wait<0>();
    hold(c.o);

    // O / max(l, 1e-30) -> bf16, staged row-major, one TMA store of 64 rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      c.l[r] += __shfl_xor_sync(0xffffffffu, c.l[r], 1);
      c.l[r] += __shfl_xor_sync(0xffffffffu, c.l[r], 2);
      c.l[r] = fmaxf(c.l[r], 1e-30f);
    }
    unsigned char* stage = smem + C::O_OFF + w * 64 * D * 2;
#pragma unroll
    for (int i = 0; i < Consumer<D>::NO; i += 2) {
      const int r = (i / 2) % 2;
      const int row = warp * 16 + lane / 4 + 8 * r;
      const int cc = 8 * (i / 4) + col;
      *reinterpret_cast<__nv_bfloat162*>(stage + (row * D + cc) * 2) =
          __floats2bfloat162_rn(c.o[i] / c.l[r], c.o[i + 1] / c.l[r]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(3 + w, kWG);
    if (t == 0 && rows < S) tma_store(&to, smem_u32(stage), 0, rows, h, b);
  }
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, reached through the runtime (no -lcuda)
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

// a 4-D map (D, S, H, B) of bf16 with element strides (ss, sh, sb) and a box
// of `cols` x `rows`
CUresult make_map(CUtensorMap* map, const void* ptr, int D, int S, int H,
                  int B, long long ss, long long sh, long long sb, int cols,
                  int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int hq, int hkv, int S, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  const CUtensorMapSwizzle swz =
      C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : C::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, to;
  CUresult r = make_map(&tq, q, D, S, hq, B, st[2], st[1], st[0], C::PANEL,
                        kBQ, swz);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, k, D, S, hkv, B, st[5], st[4], st[3], C::PANEL, C::BK,
                 swz);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, v, D, S, hkv, B, st[8], st[7], st[6], C::PANEL, C::BK,
                 swz);
  if (r == CUDA_SUCCESS)
    r = make_map(&to, o, D, S, hq, B, D, (long long)S * D,
                 (long long)hq * S * D, D, 64, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  // the opt-in above 48 KB of shared memory holds for one device: set it
  // once on each device this process launches on
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(flash_attn_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  const int nq = (S + kBQ - 1) / kBQ;
  const float sl2 = static_cast<float>(static_cast<double>(scale) *
                                       1.4426950408889634);
  flash_attn_wgmma_kernel<D><<<nq * hq * B, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, to, S, hq, hq / hkv, B, nq, causal, window, sl2);
  return cudaGetLastError();
}

}  // namespace

// q (B,Hq,S,D), k/v (B,Hkv,S,D) bf16 with the given element strides of the
// batch, head and sequence axes; o (B,Hq,S,D) contiguous bf16.  window <= 0:
// no window.  Returns a cudaError_t, or 1000 + a CUresult when the driver
// refuses a tensor map.
extern "C" int flash_attention_wgmma_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int hq,
    int hkv, int S, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, int causal, int window,
    void* stream) {
  if (B < 1 || hq < 1 || hkv < 1 || S < 1 || hq % hkv ||
      (long long)((S + kBQ - 1) / kBQ) * hq * B > 2147483647LL)
    return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, hq, hkv, S, st, scale, causal, window,
                        s);
    case 32:
      return launch<32>(q, k, v, o, B, hq, hkv, S, st, scale, causal, window,
                        s);
    case 64:
      return launch<64>(q, k, v, o, B, hq, hkv, S, st, scale, causal, window,
                        s);
    case 128:
      return launch<128>(q, k, v, o, B, hq, hkv, S, st, scale, causal,
                         window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
