// Per-head RMSNorm followed by the half-split rotary embedding, over the
// (R, T, D) q or k rows of a decoder with qk-norm (R = batch * heads):
//
//   n   = x * rsqrt(mean(x^2) + eps) * scale           (float32)
//   out = [n1 * cos - n2 * sin, n2 * cos + n1 * sin]   rounded once
//
// with n = [n1, n2] split at D/2 and cos, sin float32 (T, D/2) tables.
// Replaces oar_ocr_tpu/ops/fused_norm_rope.py:_qk_norm_rope_kernel (the
// Pallas TPU kernel); on the port's path it runs at the qk-norm + XDRoPE
// site of every HunyuanOCR decoder layer, once on q and once on k.
// Statistics and products are float32 and each output is rounded to the
// storage dtype once, after the rotary (the JAX layer rounds the norm's
// output before its float32 rotary, so in bfloat16 the two are one
// rounding apart; in float32 they agree to rounding).
//
// Design. One warp per (r, t) row, eight rows per CTA of 256 threads. Lane
// j holds the rotary pairs (i, i + D/2) for i = j, j + 32, ... < D/2 in
// registers: both halves of a pair sit in one lane, so the rotary needs no
// shuffle and no shared memory, and a warp's loads of each half are
// contiguous. At D = 128 a lane holds elements j, j + 32, j + 64, j + 96.
// sum(x^2) is one warp-shuffle reduction. PAIRS (pairs per lane) is a
// template parameter, so any even D up to 256 runs (the tests' D = 16
// too). x is read through its row and t strides, so the wrapper passes the
// (B, T, H, D) projection output viewed as (H, T, D) without a copy; the
// output is written contiguous (R, T, D).
//
// What bounds it on Hopper: device-memory bandwidth at prefill (each
// element read and written once, ~10 flops), and launch latency at decode,
// where a call covers 16 or 4 rows. Fusing it with the QKV projection or
// the KV-cache write is later work.

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

template <typename T, int PAIRS>
__global__ void __launch_bounds__(WARPS * 32)
qk_norm_rope_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, T* __restrict__ out,
                    int r_rows, int t_len, int d, long long stride_r,
                    long long stride_t, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(r_rows) * t_len) return;
  const int r = static_cast<int>(row / t_len);
  const int t = static_cast<int>(row % t_len);
  const T* xr = x + r * stride_r + t * stride_t;
  const int half = d >> 1;

  float a[PAIRS], b[PAIRS];
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int i = lane + 32 * p;
    a[p] = i < half ? to_f32(xr[i]) : 0.f;
    b[p] = i < half ? to_f32(xr[i + half]) : 0.f;
    ss = fmaf(a[p], a[p], ss);
    ss = fmaf(b[p], b[p], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  T* o = out + row * d;
  const float* c = cos_t + static_cast<long long>(t) * half;
  const float* s = sin_t + static_cast<long long>(t) * half;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int i = lane + 32 * p;
    if (i < half) {
      const float n1 = __fmul_rn(__fmul_rn(a[p], inv), to_f32(scale[i]));
      const float n2 =
          __fmul_rn(__fmul_rn(b[p], inv), to_f32(scale[i + half]));
      const float ci = c[i], si = s[i];
      store(o + i, __fsub_rn(__fmul_rn(n1, ci), __fmul_rn(n2, si)));
      store(o + i + half, __fadd_rn(__fmul_rn(n2, ci), __fmul_rn(n1, si)));
    }
  }
}

template <typename T, int PAIRS>
cudaError_t launch(const void* x, const void* scale, const void* cos_t,
                   const void* sin_t, void* out, int r, int t, int d,
                   long long stride_r, long long stride_t, float eps,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(r) * t;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qk_norm_rope_kernel<T, PAIRS><<<static_cast<unsigned>(blocks),
                                  WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(out), r, t, d, stride_r, stride_t, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, const void* cos_t,
                     const void* sin_t, void* out, int r, int t, int d,
                     long long stride_r, long long stride_t, float eps,
                     cudaStream_t stream) {
  const int half = d / 2;
  if (half <= 32) {
    return launch<T, 1>(x, scale, cos_t, sin_t, out, r, t, d, stride_r,
                        stride_t, eps, stream);
  }
  if (half <= 64) {
    return launch<T, 2>(x, scale, cos_t, sin_t, out, r, t, d, stride_r,
                        stride_t, eps, stream);
  }
  return launch<T, 4>(x, scale, cos_t, sin_t, out, r, t, d, stride_r,
                      stride_t, eps, stream);
}

}  // namespace

// x: (r, t, d) read at x[i * stride_r + j * stride_t + k] (strides in
// elements, d contiguous); scale (d,) of x's dtype; cos, sin float32
// (t, d / 2) contiguous; out (r, t, d) contiguous of x's dtype. dtype_kind
// 0 = float32, 1 = bfloat16; d even, 2 <= d <= 256. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int oar_qk_norm_rope(const void* x, const void* scale,
                                const void* cos_t, const void* sin_t,
                                void* out, int dtype_kind, int r, int t,
                                int d, long long stride_r, long long stride_t,
                                float eps, void* stream) {
  if (r <= 0 || t <= 0 || d < 2 || d > 256 || (d & 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_kind == 0) {
    err = dispatch<float>(x, scale, cos_t, sin_t, out, r, t, d, stride_r,
                          stride_t, eps, s);
  } else if (dtype_kind == 1) {
    err = dispatch<__nv_bfloat16>(x, scale, cos_t, sin_t, out, r, t, d,
                                  stride_r, stride_t, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
