// Fused pack+quantize and dequant+unpack of the int8 communication arena
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/pack_quant/pack_quant.py:
//
//  * `write_quant_rows_2d` (:73, body `_pack_quant_kernel`, :44): quantizes
//    an fp32 gradient bucket into its segment of the int8 arena, in place,
//    and emits the fp32 block scales and the residual x - q * scale ->
//    `write_quant` here, kernel `write_quant_kernel`;
//  * `read_dequant_rows_2d` (:108, body `_dequant_read_kernel`, :89): decodes
//    a segment or span of the arena into a fresh fp32 buffer ->
//    `read_dequant`, kernel `read_dequant_kernel`.
//
// The arena (src/repro_torch/mem/arena.py, QuantCommArena) is one int8
// tensor allocated once and written in place every step: the payload, laid
// out like the fp32 arena, then a page-aligned segment of fp32 scales, one
// per quant block, at byte `scale_offset + (offset / block) * 4`.  Unlike
// the reference, which writes the scale bytes with a second copy, the
// kernel stores them itself, and the reader reads them from the arena.
// Error feedback is fused: given the fp32 accumulator slice `ef`, the kernel
// quantizes x = src + ef and writes the residual back into `ef` in place
// (one IEEE add, the same one the unfused `src + ef` does, so bit for bit
// the reference's compensation at pack time).  The arithmetic is
// block_quant.cuh's, bitwise the plain version's.
//
// What bounds them: memory.  Per element, write_quant reads 4 bytes and
// writes 1 + 4/block (payload and scale share) plus, with error feedback,
// reads and writes the 4-byte accumulator (13 + 4/block in all); without
// it the residual is not needed and not written.  read_dequant reads
// 1 + 4/block and writes 4.  The least time is bytes / 3.35 TB/s.  The
// design streams each block once: one warp per quant block, 16-byte loads,
// the block kept in registers between its absmax and its encode
// (block_quant.cuh).  Any block size and any block-aligned offset run
// through the kernel; the TPU wrapper sends extents that do not tile
// (32, 128) with whole quant blocks to its oracle instead.  One launch per
// segment or span, like the reference; a grouped launch over every segment
// of a step is later work.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError(); a bad argument returns
// cudaErrorInvalidValue without launching.

#include "../../quant/csrc/block_quant.cuh"

namespace {

using namespace block_quant;

template <int VEC, bool EF>
__global__ void __launch_bounds__(kThreads)
write_quant_kernel(const float* __restrict__ src, float* ef,
                   int8_t* __restrict__ q, float* __restrict__ scales,
                   long long n_blocks, int block) {
  const WarpLoop w = warp_loop();
  for (long long b = w.first; b < n_blocks; b += w.stride)
    quantize_block<VEC, EF>(src, ef, q, scales, b, block, w.lane);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
read_dequant_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scales, float* __restrict__ out,
                    long long n_blocks, int block) {
  const WarpLoop w = warp_loop();
  for (long long b = w.first; b < n_blocks; b += w.stride)
    dequantize_block<VEC>(q, scales, out, b, block, w.lane);
}

template <int VEC>
void launch_write(const float* src, float* ef, int8_t* q, float* scales,
                  long long n_blocks, int block, cudaStream_t s) {
  if (ef)
    write_quant_kernel<VEC, true><<<grid(n_blocks), kThreads, 0, s>>>(
        src, ef, q, scales, n_blocks, block);
  else
    write_quant_kernel<VEC, false><<<grid(n_blocks), kThreads, 0, s>>>(
        src, nullptr, q, scales, n_blocks, block);
}

}  // namespace

// Quantizes src[0 : n] (+ ef[0 : n] when ef is not null) into
// arena[offset : offset + n] and its n / block scales into the arena's bytes
// from scale_byte; with ef, ef[0 : n] becomes the residual.  n and offset
// are block multiples, scale_byte a multiple of 4.  Returns a cudaError_t.
extern "C" int write_quant(int8_t* arena, const float* src, float* ef,
                           long long offset, long long n, long long scale_byte,
                           int block, void* stream) {
  if (n < 1 || block < 1 || offset < 0 || n % block || offset % block ||
      scale_byte < 0 || scale_byte % 4)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = arena + offset;
  float* scales = reinterpret_cast<float*>(arena + scale_byte);
  const bool vec = block % 4 == 0 && aligned(src, 16) && aligned(q, 4) &&
                   (!ef || aligned(ef, 16));
  if (vec)
    launch_write<4>(src, ef, q, scales, n / block, block, s);
  else
    launch_write<1>(src, ef, q, scales, n / block, block, s);
  return (int)cudaGetLastError();
}

// out[0 : n] = arena[offset : offset + n] * its scales (read from the
// arena's bytes from scale_byte).  Returns a cudaError_t.
extern "C" int read_dequant(const int8_t* arena, long long offset, long long n,
                            long long scale_byte, int block, float* out,
                            void* stream) {
  if (n < 1 || block < 1 || offset < 0 || n % block || offset % block ||
      scale_byte < 0 || scale_byte % 4)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = arena + offset;
  const float* scales = reinterpret_cast<const float*>(arena + scale_byte);
  const bool vec = block % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  if (vec)
    read_dequant_kernel<4><<<grid(n / block), kThreads, 0, s>>>(
        q, scales, out, n / block, block);
  else
    read_dequant_kernel<1><<<grid(n / block), kThreads, 0, s>>>(
        q, scales, out, n / block, block);
  return (int)cudaGetLastError();
}
