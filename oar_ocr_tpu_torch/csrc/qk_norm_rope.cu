// Per-head RMSNorm followed by the half-split rotary embedding, over the
// q and k heads of a decoder with qk-norm, for every batch row in one
// launch:
//
//   n   = x * rsqrt(mean(x^2) + eps) * scale           (float32)
//   out = [n1 * cos - n2 * sin, n2 * cos + n1 * sin]   rounded once
//
// with n = [n1, n2] split at D/2, scale the q or the k head's (D,)
// weight, and cos, sin float32 (B, T, D/2) tables, one per batch row.
// Replaces oar_ocr_tpu/ops/fused_norm_rope.py:_qk_norm_rope_kernel (the
// Pallas TPU kernel); on the port's path it runs once per HunyuanOCR
// decoder layer, at the site where the JAX layer runs its RMSNorm and
// then a float32 rotary. Statistics and products are float32 and each
// output is rounded to the storage dtype once, after the rotary. The
// decoder is float32 in either runtime, so there the kernel and the JAX
// layer agree to float32 rounding; the bfloat16 instance serves callers
// and tests that pass bfloat16.
//
// Inputs: q (B, T, Hq, D) and k (B, T, Hk, D), read through their
// (batch, token, head) strides with D contiguous (the projections'
// outputs, no copy). Outputs: q_out contiguous (B, Hq, T, D), what the
// attention takes; k_out through its (batch, head, token) strides, so
// the caller passes the layer's KV-cache slot and k lands there with no
// copy. Hk = 0 gives the single-tensor form of the JAX signature.
//
// The cache slot as a device scalar. With `slot` set, k_out is the
// layer's whole (B, Hk, C, D) cache and token t of k lands at slot
// slot[0] + t, with slot[0] clamped to [0, C - T] as
// lax.dynamic_update_slice clamps its start (the JAX cache's decode write,
// oar_ocr_tpu/vl/kv_cache.py:68-86). The slot is read on the device, so a
// launch captured into a CUDA graph writes the right slot at every replay
// while the graph advances it; without it (prefill) the caller passes the
// slot's view and k lands at its token 0. The slot may also be a (B,)
// vector, one slot per batch row (the HPD fork scheduler's branches, each
// at its own depth): row b's token t lands at slot[b] + t, each start
// clamped alike (the JAX cache's vmapped write, kv_cache.py:85-93); row b
// reads slot[b * slot_stride], stride 0 for the scalar and 1 for the
// vector. With and without a slot are separate instances (template
// SLOT): in one instance the slot's code cost the path without it 5% at
// every shape against the kernel before the slot existed, on an H100
// (tools/kernel_ab.py).
//
// Design. One warp per (b, t, h) row, eight rows per CTA of 256 threads;
// rows run over B*T*(Hq + Hk) with the head fastest, so the warps of a
// CTA share one (b, t) table row. Lane j holds the rotary pairs (i,
// i + D/2) for i = j, j + 32, ... < D/2 in registers: both halves of a
// pair sit in one lane, so the rotary needs no shuffle and no shared
// memory, and a warp's loads of each half are contiguous. Every load of a
// row (x, both halves of the scale, cos and sin) is issued before the
// sum(x^2) shuffle reduction, so a row costs one memory round trip. PAIRS
// (pairs per lane) is a template parameter, so any even D up to 256 runs
// (the tests' D = 16 too).
//
// What bounds it on Hopper: launch latency at decode, where the call
// covers Hq + Hk = 20 rows per batch row (three CTAs at B = 1), and
// device-memory bandwidth at prefill (each element read and written
// once, ~10 flops).

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

// Shapes and strides, in elements; rows = b * t * (hq + hk) < 2^31.
struct Dims {
  int b, t, hq, hk, d, rows;
  long long q_sb, q_st, q_sh;     // q (B, T, Hq, D)
  long long k_sb, k_st, k_sh;     // k (B, T, Hk, D)
  long long ko_sb, ko_sh, ko_st;  // k_out (B, Hk, T, D)
  int slots;                      // k_out's token extent C (SLOT only)
  int slot_stride;                // row b's slot at slot[b * slot_stride]
};

template <typename T, int PAIRS, bool SLOT>
__global__ void __launch_bounds__(WARPS * 32)
qk_norm_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ q_scale,
                    const T* __restrict__ k_scale,
                    const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, T* __restrict__ q_out,
                    T* __restrict__ k_out,
                    const long long* __restrict__ slot, Dims s, float eps) {
  const int lane = threadIdx.x & 31;
  const int heads = s.hq + s.hk;
  // 32-bit index arithmetic: a 64-bit division is a long call on the
  // latency path of a decode-time launch
  const unsigned row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= static_cast<unsigned>(s.rows)) return;
  const unsigned bt = row / heads;             // b * T + t
  const int h = static_cast<int>(row - bt * heads);
  const unsigned b = bt / s.t;
  const int t = static_cast<int>(bt - b * s.t);
  const int half = s.d >> 1;

  const bool is_q = h < s.hq;
  const int hh = is_q ? h : h - s.hq;
  // the k row's token in k_out; with a SLOT, past the device slot, loaded
  // first so that only the final store waits on it
  int tk = t;
  if constexpr (SLOT) {
    if (!is_q) {
      tk += static_cast<int>(min(max(__ldg(slot + b * s.slot_stride), 0LL),
                                 static_cast<long long>(s.slots - s.t)));
    }
  }
  const T* xr = is_q ? q + b * s.q_sb + t * s.q_st + hh * s.q_sh
                     : k + b * s.k_sb + t * s.k_st + hh * s.k_sh;
  const T* sc = is_q ? q_scale : k_scale;
  T* o = is_q ? q_out + ((static_cast<long long>(b) * s.hq + hh) * s.t + t)
                            * s.d
              : k_out + b * s.ko_sb + hh * s.ko_sh + tk * s.ko_st;
  const float* c = cos_t + static_cast<long long>(bt) * half;
  const float* sn = sin_t + static_cast<long long>(bt) * half;

  // every load of the row, before the reduction
  float x1[PAIRS], x2[PAIRS], s1[PAIRS], s2[PAIRS], ci[PAIRS], si[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int i = lane + 32 * p;
    const bool in = i < half;
    x1[p] = in ? to_f32(xr[i]) : 0.f;
    x2[p] = in ? to_f32(xr[i + half]) : 0.f;
    s1[p] = in ? to_f32(sc[i]) : 0.f;
    s2[p] = in ? to_f32(sc[i + half]) : 0.f;
    ci[p] = in ? c[i] : 0.f;
    si[p] = in ? sn[i] : 0.f;
  }
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    ss = fmaf(x1[p], x1[p], ss);
    ss = fmaf(x2[p], x2[p], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(s.d) + eps);

#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int i = lane + 32 * p;
    if (i < half) {
      const float n1 = __fmul_rn(__fmul_rn(x1[p], inv), s1[p]);
      const float n2 = __fmul_rn(__fmul_rn(x2[p], inv), s2[p]);
      store(o + i, __fsub_rn(__fmul_rn(n1, ci[p]), __fmul_rn(n2, si[p])));
      store(o + i + half,
            __fadd_rn(__fmul_rn(n2, ci[p]), __fmul_rn(n1, si[p])));
    }
  }
}

template <typename T, int PAIRS>
cudaError_t launch(const void* q, const void* k, const void* q_scale,
                   const void* k_scale, const void* cos_t, const void* sin_t,
                   void* q_out, void* k_out, const void* slot, const Dims& s,
                   float eps, cudaStream_t stream) {
  const int blocks = (s.rows + WARPS - 1) / WARPS;
  auto kernel = slot != nullptr ? qk_norm_rope_kernel<T, PAIRS, true>
                                : qk_norm_rope_kernel<T, PAIRS, false>;
  kernel<<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(q_scale), static_cast<const T*>(k_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(q_out), static_cast<T*>(k_out),
      static_cast<const long long*>(slot), s, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* q_scale,
                     const void* k_scale, const void* cos_t,
                     const void* sin_t, void* q_out, void* k_out,
                     const void* slot, const Dims& s, float eps,
                     cudaStream_t stream) {
  const int half = s.d / 2;
  if (half <= 32) {
    return launch<T, 1>(q, k, q_scale, k_scale, cos_t, sin_t, q_out, k_out,
                        slot, s, eps, stream);
  }
  if (half <= 64) {
    return launch<T, 2>(q, k, q_scale, k_scale, cos_t, sin_t, q_out, k_out,
                        slot, s, eps, stream);
  }
  return launch<T, 4>(q, k, q_scale, k_scale, cos_t, sin_t, q_out, k_out,
                      slot, s, eps, stream);
}

}  // namespace

// q (b, t, hq, d) at q[i * q_sb + j * q_st + h * q_sh + e], k (b, t, hk, d)
// likewise (strides in elements, d contiguous); q_scale, k_scale (d,) of
// q's dtype; cos, sin float32 (b, t, d / 2) contiguous; q_out (b, hq, t, d)
// contiguous; k_out (b, hk, t, d) at k_out[i * ko_sb + h * ko_sh +
// j * ko_st + e], or, when slot (one int64 on the device) is not null,
// (b, hk, slots, d) with token j at slot clamp(slot[0], 0, slots - t) + j,
// slots >= t; with slot_stride 1, slot holds b int64 and row i's token j
// lands at clamp(slot[i], 0, slots - t) + j (slot_stride 0: one int64 for
// every row). dtype_kind 0 = float32,
// 1 = bfloat16; d even, 2 <= d <= 256;
// b * t * (hq + hk) < 2^31 - 8 rows; hk may be 0, and then k, k_scale,
// k_out and slot are not read.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int oar_qk_norm_rope(
    const void* q, const void* k, const void* q_scale, const void* k_scale,
    const void* cos_t, const void* sin_t, void* q_out, void* k_out,
    const void* slot, int slot_stride, int dtype_kind, int b, int t,
    int hq, int hk, int d,
    int slots, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long ko_sb,
    long long ko_sh, long long ko_st, float eps, void* stream) {
  const long long rows = static_cast<long long>(b) * t * (hq + hk);
  if (b <= 0 || t <= 0 || hq < 0 || hk < 0 || hq + hk <= 0 || d < 2 ||
      d > 256 || (d & 1) || rows > 0x7fffffffLL - WARPS ||
      (slot != nullptr && (slots < t || slot_stride < 0 ||
                           slot_stride > 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims s{b, t, hq, hk, d, static_cast<int>(rows), q_sb, q_st, q_sh,
               k_sb, k_st, k_sh, ko_sb, ko_sh, ko_st, slots, slot_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_kind == 0) {
    err = dispatch<float>(q, k, q_scale, k_scale, cos_t, sin_t, q_out, k_out,
                          slot, s, eps, st);
  } else if (dtype_kind == 1) {
    err = dispatch<__nv_bfloat16>(q, k, q_scale, k_scale, cos_t, sin_t,
                                  q_out, k_out, slot, s, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
