// Block-absmax int8 quantize and dequantize for Hopper (sm_90a): the ring's
// per-hop int8 codec.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/quant/quant.py:
//
//  * `quantize_blocks` (:56, body `_quant_kernel`, :33): fp32
//    (n_blocks, block) -> int8 (n_blocks, block) and fp32 scales
//    (n_blocks, 1) -> `quantize` here, kernel `quantize_kernel`;
//  * `dequantize_blocks` (:77, body `_dequant_kernel`, :42): the inverse,
//    q * scale -> `dequantize`, kernel `dequantize_kernel`.
//
// Every reduce-scatter hop of an int8 ring (src/repro_torch/core/ring.py)
// encodes the running partial sum of each channel slice and decodes what it
// received; the all-gather encodes each slice once and decodes each of the
// slice's gathered payloads.  The arithmetic is block_quant.cuh's, bitwise
// the plain version's.
//
// What bounds them: memory.  Per element, quantize reads 4 bytes and writes
// 1 + 4/block (q and its share of the scale); dequantize reads 1 + 4/block
// and writes 4.  A handful of flops per element (an absmax, a division, a
// rounding) is far below the card's 295 flops per byte, so the least time
// is bytes / 3.35 TB/s.  The design streams each block once: one warp per
// quant block, 16-byte loads, the block kept in registers between its
// absmax and its encode (block_quant.cuh).  Any positive block size and
// any number of blocks run through the kernel; the TPU wrapper sends blocks
// that are not a multiple of 128 lanes, and block counts with no (32, 128)
// int8 tile, to its oracle instead.  One launch per payload, like the
// reference; a kernel fusing decode, add and encode of one hop is later
// work.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError(); a bad argument returns
// cudaErrorInvalidValue without launching.

#include "block_quant.cuh"

namespace {

using namespace block_quant;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long n_blocks, int block) {
  const WarpLoop w = warp_loop();
  for (long long b = w.first; b < n_blocks; b += w.stride)
    quantize_block<VEC, false>(x, nullptr, q, scales, b, block, w.lane);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long n_blocks, int block) {
  const WarpLoop w = warp_loop();
  for (long long b = w.first; b < n_blocks; b += w.stride)
    dequantize_block<VEC>(q, scales, out, b, block, w.lane);
}

}  // namespace

// q[0 : n_blocks * block], scales[0 : n_blocks] = quantize(x); all three
// contiguous.  Returns a cudaError_t.
extern "C" int quantize(const float* x, int8_t* q, float* scales,
                        long long n_blocks, int block, void* stream) {
  if (n_blocks < 1 || block < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  if (vec)
    quantize_kernel<4><<<grid(n_blocks), kThreads, 0, s>>>(x, q, scales,
                                                           n_blocks, block);
  else
    quantize_kernel<1><<<grid(n_blocks), kThreads, 0, s>>>(x, q, scales,
                                                           n_blocks, block);
  return (int)cudaGetLastError();
}

// out[0 : n_blocks * block] = q * scales, block by block.  Returns a
// cudaError_t.
extern "C" int dequantize(const int8_t* q, const float* scales, float* out,
                          long long n_blocks, int block, void* stream) {
  if (n_blocks < 1 || block < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  if (vec)
    dequantize_kernel<4><<<grid(n_blocks), kThreads, 0, s>>>(q, scales, out,
                                                             n_blocks, block);
  else
    dequantize_kernel<1><<<grid(n_blocks), kThreads, 0, s>>>(q, scales, out,
                                                             n_blocks, block);
  return (int)cudaGetLastError();
}
