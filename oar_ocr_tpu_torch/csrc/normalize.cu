// Fused per-channel normalize (+ channel swap, + pad mask) for NHWC images.
//
// Replaces oar_ocr_tpu/ops/normalize.py:_normalize_kernel (the Pallas TPU
// kernel behind normalize_images) and the inline normalize + pad mask the
// JAX main path runs at ops/det_device.py:86-90 (det) and
// ops/warp.py:308-317 (rec tiles):
//
//   out[b, y, x, c] = in[b, y, x, swap(c)] * alpha[c] + beta[c]
//                     where y < valid_h[b] and x < valid_w[b],
//                     pad[c] elsewhere (no mask when valid_h is null).
//
// Input uint8 or float32, output float32 or bfloat16, C = 3, contiguous.
//
// What bounds it on Hopper: device-memory bandwidth. Each element is read
// once and written once with no reuse (u8 -> f32: 1 B in, 4 B out; f32 ->
// f32: 4 B in, 4 B out), at two flops per element. The TPU version tiled
// an (N*H, W*C) view with per-lane coefficient rows so its vector unit saw
// no modular channel arithmetic; on the GPU the three coefficients are
// kernel arguments held in registers, so there is no coefficient traffic
// at all, and one thread per pixel keeps a warp's loads and stores on
// contiguous addresses (96 B in, 384 B out per warp for u8 -> f32). Padded
// pixels skip their loads. Vectorised 16-byte accesses are later work.
//
// Rounding: the multiply and the add are separately rounded (__fmul_rn,
// __fadd_rn, no FMA contraction) and bf16 output rounds to nearest even,
// so the result equals PyTorch's eager `(x * a + b).to(dtype)` bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Coefs {
  float alpha[3];
  float beta[3];
  float pad[3];
};

__device__ __forceinline__ float load_in(const uint8_t* p) {
  return static_cast<float>(*p);
}
__device__ __forceinline__ float load_in(const float* p) { return *p; }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The one per-pixel body shared by both entry points.
template <typename In, typename Out>
__device__ __forceinline__ void normalize_pixel(const In* __restrict__ src,
                                                Out* __restrict__ dst,
                                                const Coefs& k, bool valid,
                                                bool swap) {
  if (!valid) {
#pragma unroll
    for (int c = 0; c < 3; ++c) store_out(dst + c, k.pad[c]);
    return;
  }
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = load_in(src + c);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = swap ? v[2 - c] : v[c];
    store_out(dst + c, __fadd_rn(__fmul_rn(x, k.alpha[c]), k.beta[c]));
  }
}

template <typename In, typename Out>
__global__ void normalize_kernel(const In* __restrict__ x,
                                 Out* __restrict__ out, long long n_pix,
                                 int h, int w, const int* __restrict__ valid_h,
                                 const int* __restrict__ valid_w, Coefs k,
                                 int swap) {
  const long long hw = static_cast<long long>(h) * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n_pix; p += stride) {
    bool valid = true;
    if (valid_h != nullptr) {
      const long long b = p / hw;
      const long long r = p - b * hw;
      const int y = static_cast<int>(r / w);
      const int xc = static_cast<int>(r - static_cast<long long>(y) * w);
      valid = y < valid_h[b] && xc < valid_w[b];
    }
    normalize_pixel(x + 3 * p, out + 3 * p, k, valid, swap != 0);
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* x, void* out, long long n_pix, int h, int w,
                   const int* valid_h, const int* valid_w, const Coefs& k,
                   int swap, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n_pix + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride loop covers the rest
  normalize_kernel<In, Out><<<static_cast<int>(blocks), threads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), n_pix, h, w, valid_h,
      valid_w, k, swap);
  return cudaGetLastError();
}

}  // namespace

// in_kind: 0 = uint8, 1 = float32. out_kind: 0 = float32, 1 = bfloat16.
// valid_h / valid_w: (B,) int32 device arrays, or both null for no mask.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int oar_normalize(const void* x, int in_kind, void* out,
                             int out_kind, long long n_pix, int h, int w,
                             const void* valid_h, const void* valid_w,
                             float a0, float a1, float a2, float b0, float b1,
                             float b2, float p0, float p1, float p2,
                             int swap_rb, void* stream) {
  if (n_pix <= 0 || h <= 0 || w <= 0 ||
      (valid_h == nullptr) != (valid_w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Coefs k = {{a0, a1, a2}, {b0, b1, b2}, {p0, p1, p2}};
  const int* vh = static_cast<const int*>(valid_h);
  const int* vw = static_cast<const int*>(valid_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_kind == 0 && out_kind == 0) {
    err = launch<uint8_t, float>(x, out, n_pix, h, w, vh, vw, k, swap_rb, s);
  } else if (in_kind == 0 && out_kind == 1) {
    err = launch<uint8_t, __nv_bfloat16>(x, out, n_pix, h, w, vh, vw, k,
                                         swap_rb, s);
  } else if (in_kind == 1 && out_kind == 0) {
    err = launch<float, float>(x, out, n_pix, h, w, vh, vw, k, swap_rb, s);
  } else if (in_kind == 1 && out_kind == 1) {
    err = launch<float, __nv_bfloat16>(x, out, n_pix, h, w, vh, vw, k,
                                       swap_rb, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
