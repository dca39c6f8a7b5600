// Hopper kernels K1 (quantize) and K2 (dequantize): per-128-block absmax int8
// link compression, DaeMon's page-class wire format.
//
// Replaces: src/repro/kernels/block_quant/block_quant.py, _quant_kernel
// (launched by quantize_pallas) and _dequant_kernel (dequantize_pallas).
//
// Bound on the H100: memory.  K1 reads 4 B (f32) or 2 B (bf16) per element and
// writes 1 B of code plus 4/128 B of scale; K2 reads 1 + 4/128 B and writes 2
// or 4 B.  A handful of operations per element is far below the ~295
// operations per byte at which the card stops being limited by its 3.35 TB/s,
// so the kernels can only be as fast as those bytes move.
//
// Design: a quantization block is 128 contiguous elements of the flattened
// (R, C) tensor.  C % 128 == 0, so no block straddles a row and the (R, C/128)
// scales are the blocks in order: the row count never matters, and warps past
// the last block return (the ragged edge).  One warp takes one block: each
// lane moves its 4 elements with one 16-byte (f32) or 8-byte (bf16) load, the
// absmax is a warp-shuffle reduction, and lane 0 writes the scale.  Every load
// and store is coalesced and a block never leaves registers, so each byte
// crosses the memory bus once.
//
// Numerics follow quantize_ref / dequantize_ref exactly: bf16 input is widened
// to f32 before the absmax; scale = absmax / 127 and x / safe are IEEE
// divisions (no reciprocal; build without --use_fast_math); rounding is half
// to even (rintf, as jnp.round and torch.round); bf16 output rounds to nearest
// even (__floats2bfloat162_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;       // elements per quantization block
constexpr int kWarpsPerCta = 8;   // one block per warp

__device__ __forceinline__ void load4(const float* x, long long i, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(x + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* x, long long i, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(x + i);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* out, long long i, const float v[4]) {
  *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(out + i) = t;
}

__device__ __forceinline__ signed char code(float x, float safe) {
  return static_cast<signed char>(fminf(fmaxf(rintf(x / safe), -127.0f), 127.0f));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long n_blocks) {
  const long long blk = static_cast<long long>(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32;
  if (blk >= n_blocks) return;  // whole warp leaves together: shuffles stay full
  const int lane = threadIdx.x % 32;
  const long long i = blk * kBlock + lane * 4;
  float v[4];
  load4(x, i, v);
  float m = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = m / 127.0f;
  const float safe = scale == 0.0f ? 1.0f : scale;
  char4 c;
  c.x = code(v[0], safe); c.y = code(v[1], safe); c.z = code(v[2], safe); c.w = code(v[3], safe);
  *reinterpret_cast<char4*>(q + i) = c;
  if (lane == 0) scales[blk] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  T* __restrict__ out, long long n_blocks) {
  const long long blk = static_cast<long long>(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32;
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x % 32;
  const long long i = blk * kBlock + lane * 4;
  const char4 c = *reinterpret_cast<const char4*>(q + i);
  const float s = scales[blk];
  const float v[4] = {static_cast<float>(c.x) * s, static_cast<float>(c.y) * s,
                      static_cast<float>(c.z) * s, static_cast<float>(c.w) * s};
  store4(out, i, v);
}

dim3 grid_for(long long n_blocks) {
  return dim3(static_cast<unsigned>((n_blocks + kWarpsPerCta - 1) / kWarpsPerCta));
}

}  // namespace

// x: n_blocks * 128 contiguous f32 (x_bf16 == 0) or bf16 elements, 16-byte
// aligned; q: as many int8; scales: n_blocks f32.  Returns cudaGetLastError().
extern "C" int bq_quantize(const void* x, int x_bf16, void* q, void* scales,
                           long long n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    quantize_kernel<__nv_bfloat16><<<grid_for(n_blocks), kWarpsPerCta * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n_blocks);
  } else {
    quantize_kernel<float><<<grid_for(n_blocks), kWarpsPerCta * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: n_blocks * 128 int8; scales: n_blocks f32; out: as many f32
// (out_bf16 == 0) or bf16 elements.  Returns cudaGetLastError().
extern "C" int bq_dequantize(const void* q, const void* scales, void* out, int out_bf16,
                             long long n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    dequantize_kernel<__nv_bfloat16><<<grid_for(n_blocks), kWarpsPerCta * 32, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), n_blocks);
  } else {
    dequantize_kernel<float><<<grid_for(n_blocks), kWarpsPerCta * 32, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch bq_quantize makes for n_blocks blocks of x (x_bf16 selects the
// instance), for trace capture to check its model against: out[0..2] the
// grid, out[3] threads a CTA, out[4] dynamic shared memory bytes, out[5] the
// CTAs an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int bq_quantize_launch(int x_bf16, long long n_blocks, int* out) {
  const int threads = kWarpsPerCta * 32;
  int per_sm = 0;
  const cudaError_t err =
      x_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, quantize_kernel<__nv_bfloat16>, threads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_kernel<float>,
                                                             threads, 0);
  const dim3 grid = grid_for(n_blocks);
  out[0] = static_cast<int>(grid.x); out[1] = static_cast<int>(grid.y);
  out[2] = static_cast<int>(grid.z); out[3] = threads; out[4] = 0; out[5] = per_sm;
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
