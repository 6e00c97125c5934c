// Blockwise (flash) attention with per-batch key lengths and optional
// causal masking, for contiguous (B, H, T, D) float32 or bfloat16 tensors.
//
// Replaces oar_ocr_tpu/ops/flash_attention.py:_flash_kernel (the Pallas
// TPU kernel). For each (b, h) and query row i:
//
//   out[i] = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp(q_i.k_j * scale - m_i)
//
// over the keys j < valid_len[b] (and j <= i when causal), with
// scale = 1/sqrt(D) applied to q in float32 before the product. A row with
// every key masked outputs exactly 0 (the kernel's l == 0 guard). Query
// rows at or past valid_len still attend the valid keys; the caller drops
// them. Scores, the running statistics and the accumulator are float32;
// P stays float32 for the PV product.
//
// Design. One CTA of 256 threads per (b*h, block of 64 query rows). The
// q block is staged in shared memory once, scaled; K and V then stream
// through shared memory in blocks of 64 keys, converted to float32 on the
// way in, and each block updates the per-row running max m, sum l and the
// 64 x D accumulator (the online-softmax recurrence), so the (T, T) score
// matrix never exists. Key blocks past valid_len[b] (and, when causal,
// above the diagonal) are skipped: they would leave m, l and acc unchanged.
// The TPU kernel held the whole K/V row in VMEM and padded D to 128 lanes;
// here D is a template parameter (72 for the PaddleOCR-VL vision tower,
// 128 for the decoder head size) and no padded copy is made.
//
// What bounds it on Hopper: arithmetic. It does 4*T*T*D flops per head
// against 4*T*D*bytes of traffic. This first version runs them as float32
// FMAs from shared memory (each thread a 4 x 4 score tile and a 4 x D/16
// accumulator tile), so it is held by shared-memory load bandwidth at
// roughly half the card's float32 FMA rate, far below the tensor cores.
// mma/wgmma tiles and TMA loads are later work.
//
// Shared-memory rows of Q and K have an odd stride (D + 1), so the 16
// distinct K rows a warp reads at one d fall in 16 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per shared-memory block
constexpr int THREADS = 256;  // 16 x 16 tile threads / 64 rows x 4 stat threads
constexpr float NEG = -1e30f; // initial running max (finite: no inf - inf)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
struct Layout {
  static constexpr int QS = D + 1;  // Q row stride (floats)
  static constexpr int KS = D + 1;  // K row stride
  static constexpr int VS = D;      // V row stride
  static constexpr int SS = BK + 1; // score/probability row stride
  static constexpr int NJ = (D + 15) / 16;  // accumulator columns a thread owns
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QS;
  static constexpr int V_OFF = K_OFF + BK * KS;
  static constexpr int S_OFF = V_OFF + BK * VS;
  static constexpr int A_OFF = S_OFF + BQ * SS;  // per-row rescale alpha
  static constexpr int L_OFF = A_OFF + BQ;       // per-row final l
  static constexpr size_t BYTES = (L_OFF + BQ) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const int* __restrict__ valid_len, int heads, int tq, int tk,
             float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* As = smem + L::A_OFF;
  float* Ls = smem + L::L_OFF;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long q_base = static_cast<long long>(bh) * tq * D;
  const long long k_base = static_cast<long long>(bh) * tk * D;
  int vlen = tk;
  if (valid_len != nullptr) {
    vlen = min(max(valid_len[bh / heads], 0), tk);
  }

  // tile roles: rows ty*4 + i, score columns tx + 16*j, output columns
  // tx + 16*j (j < NJ, masked at D)
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // statistics roles: 4 threads per row, 16 score columns each
  const int srow = tid >> 2;
  const int part = tid & 3;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int c = e - r * D;
    Qs[r * L::QS + c] =
        q0 + r < tq ? to_f32(q[q_base + static_cast<long long>(q0) * D + e]) * scale
                    : 0.f;
  }

  float acc[4][L::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < L::NJ; ++j) acc[i][j] = 0.f;
  float m_run = NEG;  // replicated over the 4 statistics threads of a row
  float l_run = 0.f;

  int nk = (vlen + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    const long long g0 = k_base + static_cast<long long>(k0) * D;
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D;
      const int c = e - r * D;
      const bool in = k0 + r < tk;
      Ks[r * L::KS + c] = in ? to_f32(k[g0 + e]) : 0.f;
      Vs[r * L::VS + c] = in ? to_f32(v[g0 + e]) : 0.f;
    }
    __syncthreads();  // also orders the Q staging before the first use

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < vlen && (!causal || kj <= qi);
        Ss[(ty * 4 + i) * L::SS + tx + 16 * j] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    {
      // masked scores are -inf: they never raise the max, and with m_run
      // finite their exp is exactly 0
      float* row = Ss + srow * L::SS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      if (part == 0) As[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = As[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < L::NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * L::SS + kk];
#pragma unroll
      for (int j = 0; j < L::NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float vv = Vs[kk * L::VS + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // K, V and S are overwritten by the next block
  }

  if (part == 0) Ls[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= tq) continue;
    const float l = Ls[r] == 0.f ? 1.f : Ls[r];
    T* dst = out + q_base + static_cast<long long>(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < L::NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(dst + c, acc[i][j] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* valid_len, int bh, int heads, int tq, int tk,
                   float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<D>::BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_kernel<T, D><<<grid, THREADS, Layout<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), valid_len, heads, tq,
      tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* out, const int* valid_len, int bh, int heads,
                       int tq, int tk, float scale, int causal,
                       cudaStream_t s) {
  switch (d) {
    case 72:
      return launch<T, 72>(q, k, v, out, valid_len, bh, heads, tq, tk, scale,
                           causal, s);
    case 128:
      return launch<T, 128>(q, k, v, out, valid_len, bh, heads, tq, tk,
                            scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Tq, D), k/v (B, H, Tk, D), out like q; all contiguous, one dtype
// (dtype_kind 0 = float32, 1 = bfloat16). valid_len: (B,) int32 device
// array or null (every key valid). D must be 72 or 128. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int oar_flash_attention(const void* q, const void* k,
                                   const void* v, void* out,
                                   const void* valid_len, int dtype_kind,
                                   int batch, int heads, int tq, int tk,
                                   int d, float scale, int causal,
                                   void* stream) {
  const long long bh = static_cast<long long>(batch) * heads;
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_kind == 0) {
    err = dispatch_d<float>(d, q, k, v, out, vl, static_cast<int>(bh), heads,
                            tq, tk, scale, causal, s);
  } else if (dtype_kind == 1) {
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, out, vl,
                                    static_cast<int>(bh), heads, tq, tk,
                                    scale, causal, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
