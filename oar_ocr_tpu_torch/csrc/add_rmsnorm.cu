// Fused residual add + RMSNorm over the rows of a (R, D) float32 or
// bfloat16 matrix:
//
//   s      = x + r                         (float32)
//   sum    = round(s)                      (storage dtype)
//   normed = round(s * rsqrt(mean(s^2) + eps) * scale)
//
// Replaces oar_ocr_tpu/ops/fused_norm_rope.py:_add_rmsnorm_kernel (the
// Pallas TPU kernel): the layer-boundary pair of a pre-norm decoder, here
// the 36 norm sites of the Ernie-4.5 decoder of PaddleOCR-VL. Statistics
// and products are float32; each output is rounded to the storage dtype
// once, so the bfloat16 `sum` equals (x.float() + r.float()).bfloat16()
// bit for bit.
//
// Design. One warp per row, eight rows per CTA of 256 threads. Lane c
// walks columns c, c + 32, ..., so a warp's loads and stores are
// contiguous. The first pass reduces sum(s^2) with warp shuffles; the
// second recomputes s from x and r (the same float32 add, so the same
// bits; the row is in L1 by then) and writes both outputs. Nothing goes
// through shared memory and no block-wide barrier is needed.
//
// What bounds it on Hopper: device-memory bandwidth at prefill (R = B*T
// rows: two reads and two writes of each element, a handful of flops), and
// launch latency at decode, where R = B is two rows and one CTA runs on
// one SM. Vectorised 16-byte accesses and fusing the decode step's
// launches (CUDA graphs) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
add_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ scale, T* __restrict__ normed,
                   T* __restrict__ sum, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = static_cast<long long>(row) * d;

  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float s = __fadd_rn(to_f32(x[base + c]), to_f32(r[base + c]));
    ss = fmaf(s, s, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  for (int c = lane; c < d; c += 32) {
    const float s = __fadd_rn(to_f32(x[base + c]), to_f32(r[base + c]));
    store(sum + base + c, s);
    store(normed + base + c, __fmul_rn(__fmul_rn(s, inv), to_f32(scale[c])));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* scale,
                   void* normed, void* sum, int rows, int d, float eps,
                   cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  add_rmsnorm_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<T*>(normed),
      static_cast<T*>(sum), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, r, normed, sum: (rows, d) contiguous; scale (d,); one dtype for all
// (dtype_kind 0 = float32, 1 = bfloat16). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int oar_add_rmsnorm(const void* x, const void* r,
                               const void* scale, void* normed, void* sum,
                               int dtype_kind, int rows, int d, float eps,
                               void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_kind == 0) {
    err = launch<float>(x, r, scale, normed, sum, rows, d, eps, s);
  } else if (dtype_kind == 1) {
    err = launch<__nv_bfloat16>(x, r, scale, normed, sum, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
