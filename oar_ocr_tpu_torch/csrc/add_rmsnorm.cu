// Fused residual add + RMSNorm over the rows of a (R, D) float32 or
// bfloat16 matrix:
//
//   s      = x + r                         (float32)
//   sum    = round(s)                      (storage dtype)
//   normed = round(s * rsqrt(mean(s^2) + eps) * scale)
//
// Replaces oar_ocr_tpu/ops/fused_norm_rope.py:_add_rmsnorm_kernel (the
// Pallas TPU kernel): the layer-boundary pair of a pre-norm decoder, here
// the 36 norm sites of the Ernie-4.5 decoder of PaddleOCR-VL and the 48
// of HunyuanOCR's. Statistics and products are float32; each output is
// rounded to the storage dtype once, so the bfloat16 `sum` equals
// (x.float() + r.float()).bfloat16() bit for bit.
//
// What bounds it on Hopper: device-memory bandwidth at prefill (R = B*T
// rows: two reads and two writes of each element, a handful of flops),
// and latency at decode, where R = B is one or two rows: there the time
// is the launch plus the chain of dependent steps one row takes (load,
// reduce, write), and bandwidth is idle. The design, one kernel body for
// both cases, chosen by the entry point from the row count:
//   - few rows (fewer than the card's SMs): one CTA of 128 threads per
//     row, so the row's loads are spread over four warps, each thread
//     issuing one or two 16-byte loads of x and r at once;
//   - many rows: one warp per row, eight rows per CTA, as many CTAs as
//     rows / 8, which keeps every SM streaming;
//   - either way a thread loads its columns of x and r once, as 16-byte
//     vectors (4 floats or 8 bfloat16), keeps s in registers through the
//     reduction (warp shuffles, then one small shared array across the
//     row's warps) and writes both outputs from them;
//   - a width that is not a multiple of the vector, a base address that
//     is not 16-byte aligned (a contiguous view can start anywhere), or a
//     row longer than the registers hold takes a scalar loop that reads
//     x and r twice, once for the statistics and once to write.
// Only the order of the float32 sum of squares differs between paths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as N floats
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 1 / sqrt(mean(s^2) + eps) from each thread's part of sum(s^2): shuffles
// within each warp, then the row's RT / 32 warp sums through shared memory
template <int RT, int RPC>
__device__ __forceinline__ float row_inv(float ss, int d, float eps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if constexpr (RT > 32) {
    constexpr int W = RT / 32;
    __shared__ float part[RPC][W];
    const int sub = threadIdx.x / RT;
    const int warp = (threadIdx.x % RT) >> 5;
    if ((threadIdx.x & 31) == 0) part[sub][warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += part[sub][w];
  }
  return 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
}

// RT threads per row, RPC rows per CTA; VEC: 16-byte accesses with up to
// NV vectors of the row per thread held in registers (the entry point
// checks width, alignment and length), else the scalar two-pass loop.
template <typename T, int RT, int RPC, int NV, bool VEC>
__global__ void __launch_bounds__(RT * RPC)
add_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ scale, T* __restrict__ normed,
                   T* __restrict__ sum, int rows, int d, float eps) {
  const int t = threadIdx.x % RT;
  const int row = blockIdx.x * RPC + threadIdx.x / RT;
  // a CTA of several rows has one warp per row (RT == 32) and no barrier,
  // so a thread past the last row may leave
  if (RPC > 1 && row >= rows) return;
  const long long base = static_cast<long long>(row) * d;
  const T* xr = x + base;
  const T* rr = r + base;
  T* nr = normed + base;
  T* sr = sum + base;

  float ss = 0.f;
  if constexpr (VEC) {
    constexpr int N = Vec<T>::N;
    float s[NV][N];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * RT) * N;
      if (c < d) {
        float a[N], b[N];
        load16(xr + c, a);
        load16(rr + c, b);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s[i][e] = __fadd_rn(a[e], b[e]);
          ss = fmaf(s[i][e], s[i][e], ss);
        }
      }
    }
    const float inv = row_inv<RT, RPC>(ss, d, eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * RT) * N;
      if (c < d) {
        float g[N], n[N];
        load16(scale + c, g);
#pragma unroll
        for (int e = 0; e < N; ++e)
          n[e] = __fmul_rn(__fmul_rn(s[i][e], inv), g[e]);
        store16(sr + c, s[i]);
        store16(nr + c, n);
      }
    }
  } else {
    for (int c = t; c < d; c += RT) {
      const float s = __fadd_rn(to_f32(xr[c]), to_f32(rr[c]));
      ss = fmaf(s, s, ss);
    }
    const float inv = row_inv<RT, RPC>(ss, d, eps);
    for (int c = t; c < d; c += RT) {
      const float s = __fadd_rn(to_f32(xr[c]), to_f32(rr[c]));
      store(sr + c, s);
      store(nr + c, __fmul_rn(__fmul_rn(s, inv), to_f32(scale[c])));
    }
  }
}

// few rows: a CTA of 128 threads per row, rows up to 128 * 4 vectors
constexpr int FEW_RT = 128, FEW_NV = 4;
// many rows: a warp per row, eight rows per CTA, rows up to 32 * 8 vectors
constexpr int MANY_RPC = 8, MANY_NV = 8;

template <typename T, int RT, int RPC, int NV>
cudaError_t launch_rows(const void* x, const void* r, const void* scale,
                        void* normed, void* sum, int rows, int d, float eps,
                        bool vec, cudaStream_t stream) {
  const int blocks = (rows + RPC - 1) / RPC;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* gt = static_cast<const T*>(scale);
  T* nt = static_cast<T*>(normed);
  T* st = static_cast<T*>(sum);
  if (vec && d <= RT * NV * Vec<T>::N) {
    add_rmsnorm_kernel<T, RT, RPC, NV, true>
        <<<blocks, RT * RPC, 0, stream>>>(xt, rt, gt, nt, st, rows, d, eps);
  } else {
    add_rmsnorm_kernel<T, RT, RPC, NV, false>
        <<<blocks, RT * RPC, 0, stream>>>(xt, rt, gt, nt, st, rows, d, eps);
  }
  return cudaGetLastError();
}

// the current device's SM count, read once per device (the caller makes
// the tensors' card current); devices past the table read it every call
constexpr int SM_CACHE_DEVICES = 64;

int sm_count() {
  static std::atomic<int> cached[SM_CACHE_DEVICES];  // zero: static
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    return 132;  // the H100 SXM's; only the choice of path depends on it
  }
  const bool cacheable = dev >= 0 && dev < SM_CACHE_DEVICES;
  int n = cacheable ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      return 132;
    }
    if (cacheable) cached[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* scale,
                   void* normed, void* sum, int rows, int d, float eps,
                   cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(scale) |
                        reinterpret_cast<uintptr_t>(normed) |
                        reinterpret_cast<uintptr_t>(sum);
  // rows start d elements apart, so d a multiple of the vector keeps every
  // row's start as aligned as the base
  const bool vec = (any % 16) == 0 && d % Vec<T>::N == 0;
  if (rows < sm_count()) {
    return launch_rows<T, FEW_RT, 1, FEW_NV>(x, r, scale, normed, sum, rows,
                                             d, eps, vec, stream);
  }
  return launch_rows<T, 32, MANY_RPC, MANY_NV>(x, r, scale, normed, sum,
                                               rows, d, eps, vec, stream);
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
