// Blockwise (flash) attention with per-batch key lengths and optional
// causal masking, over (B, H, T, D) float32 or bfloat16 q, k, v read
// through their (batch, head, token) strides, with unit stride in D.
//
// Replaces oar_ocr_tpu/ops/flash_attention.py:_flash_kernel (the Pallas
// TPU kernel), in both dtypes. For each (b, h) and query row i:
//
//   out[i] = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp(q_i.k_j * scale - m_i)
//
// over the keys j < valid_len[b] (and j <= i when causal), scale =
// 1/sqrt(D). A row with every key masked outputs exactly 0. Query rows at
// or past valid_len still attend the valid keys; the caller drops them.
// The row statistics and the accumulator are float32. The output is
// written in (B, T, H, D) memory, so the caller's transpose back to
// tokens costs no copy. D is 64 (the VL family towers, HPD's InternViT),
// 72 (the PaddleOCR-VL, HunyuanOCR, OvisOCR2 and MonkeyOCRv2 towers), 80
// (MinerU's Qwen2-VL tower; float32 only, since the exact towers that run
// it are float32) or 128 (the decoder head size, GLM-OCR's tower); no
// padded copy of any input is made. D = 64 is the D = 72 design without
// its tail: one 64-wide swizzled part in bfloat16, and in float32 the
// D = 72 tiling with no tail columns (100 KB of shared memory). In float32
// D = 80 keeps that tiling with two tail columns a thread and 56-key
// blocks: 64-key ones would take 120 KB of shared memory a CTA, too much
// for two CTAs on an SM (108 KB at 56 keys).
//
// bfloat16: flash_wgmma_kernel. What bounds it on Hopper: operations,
// 4*T*T*D per head on the tensor cores (0.107 ms at HunyuanOCR's
// (1, 16, 4800, 72) at 989 TFLOP/s), and at D = 72 nearly as much the
// exponentials: 16 * 4800^2 = 3.7e8 exp2 on the special-function units
// (16 a clock per SM, ~0.1 ms), besides the softmax's other float32 work.
// The design:
//   - a CTA of 128 query rows: two consumer warpgroups of 64 rows and one
//     producer warp;
//   - the producer loads the Q tile once and streams K and V blocks of BK
//     keys (128 at D = 72; 64 at D = 128, for registers) through a ring
//     of STAGES stages with TMA (cp.async.bulk.tensor, 4-d tensor maps
//     over the strided inputs, built in the entry point) and mbarriers,
//     K and V released apart; TMA zero-fills rows past T, and the mask
//     decides what counts;
//   - S = Q K^T is wgmma m64nBKk16 with both operands K-major in shared
//     memory under the 128-byte swizzle; O += P V is wgmma m64n64k16 with
//     P as a register operand (rounded to bfloat16 there, as the JAX
//     fallback rounds its weights to v's dtype) and V read MN-major
//     through the transpose bit. The score matrix never leaves registers;
//   - D = 72 is 64 + 8: the 64-wide part has 128-byte rows and takes the
//     swizzle; the 8-wide tail is its own unswizzled tile, whose second
//     k8 half the descriptor points at a zero block, so Q K^T takes one
//     more k16 step and P V one n8 instruction;
//   - softmax in registers: the row max is reduced over the four lanes of
//     a fragment row by shuffles, scale*log2(e) is folded into one FMA
//     before ex2, O is rescaled only when a row's max grows by more than
//     2^8, the mask runs only on key blocks that straddle valid_len or
//     the causal diagonal, and blocks wholly past either are never loaded;
//   - the exponentials of block j run while the tensor cores run P V of
//     block j-1 (issued with Q K^T of block j), and the two warpgroups
//     take turns to issue (named barriers), so one's softmax runs under
//     the other's products.
//
// float32: flash_fma_kernel. What bounds it: operations, 4*T*T*D per
// head as float32 FMAs at 67 TFLOP/s (1.6 ms at HunyuanOCR's (1, 16,
// 4800, 72)). It stays off the tensor cores on purpose: TF32 would round
// q, k and v to 10 bits and break the float32 card-against-CPU gates. An
// SM retires 128 FMAs a clock but one shared-memory wavefront, so the
// design keeps operands in registers and shared-memory traffic low:
//   - register tiles at D = 64, 72 and 80 (Fma): a thread scores TM = 4
//     query rows against BK / 8 keys and owns those rows of O; Q and K
//     rows are D + 4 floats apart (16-byte aligned, no bank conflicts),
//     so q.k^T runs on 128-bit loads along d, 12 loads for 128 FMAs;
//   - P goes to shared memory as [key][row] and P V reads a key's four
//     probabilities as one float4; the 8 threads of a row group own whole
//     float4 groups of O's columns (two each) and at D = 72 and 80 the
//     tail columns, so no lane idles;
//   - K and V stream through a two-stage ring of 16-byte cp.async.cg
//     copies, block j + 1 landing while block j is computed; keys past
//     valid_len (and T) are not copied, and the mask decides what counts;
//     Q is staged once, scaled by scale * log2(e);
//   - a key block that straddles valid_len (or the causal diagonal's last
//     row) scores only the ceil(keys / 8) columns a thread has keys in
//     and runs P V over its keys alone: HPD's 1025 tokens leave one key in
//     their 17th block, which had cost a whole block;
//   - the softmax runs in registers on exp2, with the row max and sum
//     reduced by shuffles over a row group's lanes; the running max
//     starts finite, so masked (-inf) scores give exactly 0 and a row
//     with no valid key outputs 0; blocks wholly past valid_len or the
//     causal diagonal are never loaded; two barriers a block;
//   - two CTAs per SM: 64 query rows, 64-key blocks and 128 threads at
//     D = 72 (110 KB of shared memory), with no spills; a causal grid
//     launches its longest query tiles first;
//   - the grid: a CTA per (b, h, query tile) runs in ceil(CTAs / slots)
//     waves of the 132 x 2 slots, and HPD's InternViT tiles (16 heads x
//     17 tiles of 1025 rows an image) overshoot a whole wave by 8 CTAs at
//     every image count. So D = 64 also has a stream grid: one CTA a
//     slot, each running an equal share of the (b h, tile, key block)
//     units; a tile cut between CTAs leaves each one's m, l and
//     unnormalized O in a workspace, and the last to finish merges them.
//     Its instance (FmaD64S) takes 32-key blocks, so its 60 KB of shared
//     memory lets three CTAs (12 warps) share an SM: 396 slots, and more
//     warps to hide the latency of the shared loads and barriers. The
//     caller's launch rule (ops/flash_attention.py fma_grid) picks the
//     grid from the shape;
//   - D = 128 (FmaSplit): a row's O is 128 floats, so a thread that
//     scored 4 rows could not also hold them. Scoring and P V map the
//     threads apart: a 4 x 8 score tile a thread (12 loads for 128 FMAs,
//     as at D = 72), then 8 P slots x 8 columns of O (4 loads for 64 FMAs),
//     with each row's rescale passed through shared memory beside P. One
//     CTA an SM: 128 rows, 64-key blocks and 256 threads fill 227 KB of
//     shared memory and up to 255 registers a thread. Every load address
//     is a base register plus a constant (Q swizzled by the row's low
//     two bits, K rows padded, each warp copying whole rows). The two CTAs
//     of a cluster split a tile's key blocks and merge their halves
//     through distributed shared memory, so GLM-OCR's 588 tiles of
//     (1, 12, 6256, 128) fill 8.9 waves of the 132 SMs, not 4.45.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG = -1e30f;  // initial running max (finite: no inf - inf)

// element strides of q, k, v over (batch, head, token); D is unit-stride
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt;
};

// 2^x on the special-function unit (both kernels' softmax)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ float32

constexpr float LOG2E = 1.4426950408889634f;

// One 16-byte cp.async from global to shared memory through L2 only;
// `bytes` < 16 fills the rest with zeros (0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float32 tiling. A CTA takes BQ query rows; a thread owns TM of them
// (a row group: rows rg + (BQ / TM) * i, so the row groups of a warp read
// adjacent Q rows, which fall in distinct banks), and the G threads of a
// row group, adjacent lanes, split its BK keys (key cg + G*j) and its D
// output columns (the float4 groups cg + G*g, then TAIL columns each of
// the last D mod 4G). K and V blocks go through a ring of STAGES stages.
template <int D_, int TM_, int G_, int BQ_, int BK_, int STAGES_,
          int CTAS_ = 2>
struct Fma {
  static constexpr bool SPLIT = false;
  static constexpr int D = D_, TM = TM_, G = G_, BQ = BQ_, BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr int CTAS = CTAS_;  // CTAs an SM (__launch_bounds__)
  static constexpr int SPLITK = 1;  // CTAs a tile
  static constexpr int THREADS = BQ / TM * G;
  static constexpr int RS = BQ / TM;           // row stride within a group
  static constexpr int KN = BK / G;            // keys a thread scores
  static constexpr int D4 = D / 4;             // float4 groups of a row
  static constexpr int NF4 = D4 / G;           // float4 groups a thread owns
  static constexpr int TAIL = (D - 4 * G * NF4) / G;
  static constexpr int NC = 4 * NF4 + TAIL;    // output columns a thread owns
  // Q and K rows are D + 4 floats apart: 16-byte aligned, and the eight
  // rows a quarter-warp reads with one 128-bit load fall in distinct banks
  static constexpr int QP = D + 4;
  static constexpr int KP = D + 4;
  static constexpr int VP = D;       // a quarter-warp reads one V row
  static constexpr int PP = BQ + 4;  // P is [key][row]
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QP;
  static constexpr int V_OFF = K_OFF + STAGES * BK * KP;
  static constexpr int P_OFF = V_OFF + STAGES * BK * VP;
  static constexpr int BYTES = (P_OFF + BK * PP) * sizeof(float);
  static_assert(D % 4 == 0 && TM % 4 == 0 && BQ % TM == 0 && BK % G == 0,
                "tile shapes");
  static_assert(G <= 32 && (G & (G - 1)) == 0, "a row group is 2^n lanes");
  static_assert((D - 4 * G * NF4) % G == 0, "tail columns split evenly");
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

// A thread's share of an Fma tile's running state: its TM rows of O (NC
// columns each), their running max m and its part of their row sums l.
template <class C>
struct FmaRows {
  float o[C::TM][C::NC];
  float m[C::TM], l[C::TM];
};

// The body of an Fma tiling: each thread scores its TM rows and owns the
// same rows of O. Query tile q0 of head (b, h) attends key blocks
// [jb, je) into r, which the caller cleared (or holds earlier blocks of
// the same tile). vlen: the valid keys of batch b.
template <class C>
__device__ __forceinline__ void fma_tile(
    float* smem_f32, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, Strides st, int b, int h, int tq, int vlen,
    int q0, int jb, int je, float scale_log2, int causal, FmaRows<C>& r) {
  constexpr int D = C::D, TM = C::TM, G = C::G, BQ = C::BQ, BK = C::BK;
  constexpr int KN = C::KN, D4 = C::D4, NF4 = C::NF4, TAIL = C::TAIL;
  constexpr int NC = C::NC, STAGES = C::STAGES, THREADS = C::THREADS;
  const float* Qs = smem_f32 + C::Q_OFF;
  float* Ps = smem_f32 + C::P_OFF;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_f32));

  const int tid = threadIdx.x;
  // row offsets inside a block are 32-bit: (row < BQ or BK) * token stride
  const int qt = static_cast<int>(st.qt);
  const int kt = static_cast<int>(st.kt);
  const int vt = static_cast<int>(st.vt);
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  // the keys any row of the tile may attend end at kmax
  const int kmax = causal ? min(vlen, q0 + BQ) : vlen;

  // every thread is done with the shared memory of the previous tile
  __syncthreads();
  // K and V of block j into stage (j - jb) % STAGES: only its keys below
  // valid_len, which the scores and P V of a ragged block read (the keys
  // past it are masked, whatever the stage holds)
  auto load_kv = [&](int j) {
    const int s = (j - jb) % STAGES;
    const int k0 = j * BK;
    const int rows = min(BK, vlen - k0);
    const float* kb = kp + static_cast<long long>(k0) * st.kt;
    const float* vb = vp + static_cast<long long>(k0) * st.vt;
    const uint32_t ks = base + (C::K_OFF + s * BK * C::KP) * 4;
    const uint32_t vs = base + (C::V_OFF + s * BK * C::VP) * 4;
    for (int e = tid; e < rows * D4; e += THREADS) {
      const int rr = e / D4;
      const int c = (e - rr * D4) * 4;
      cp_async16(ks + (rr * C::KP + c) * 4, kb + rr * kt + c, 16u);
      cp_async16(vs + (rr * C::VP + c) * 4, vb + rr * vt + c, 16u);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (jb + j < je) load_kv(jb + j);
    cp_async_commit();
  }

  // Q, scaled by scale*log2(e) so the softmax takes exp2 of the scores;
  // rows past T are 0
  {
    const float* qp = q + b * st.qb + h * st.qh +
                      static_cast<long long>(q0) * st.qt;
    float* qs = smem_f32 + C::Q_OFF;
    for (int e = tid; e < BQ * D4; e += THREADS) {
      const int rr = e / D4;
      const int c = (e - rr * D4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + rr < tq) {
        x = __ldg(reinterpret_cast<const float4*>(qp + rr * qt + c));
        x.x *= scale_log2;
        x.y *= scale_log2;
        x.z *= scale_log2;
        x.w *= scale_log2;
      }
      *reinterpret_cast<float4*>(qs + rr * C::QP + c) = x;
    }
  }

  const int rg = tid / G;
  const int cg = tid % G;
  const int row0 = q0 + rg;  // this thread's rows: row0 + RS * i
  const float* Qr = Qs + rg * C::QP;

  for (int j = jb; j < je; ++j) {
    // block j has landed for every thread, and every thread is done with
    // block j - 1: its stage and P may be overwritten
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < je) load_kv(j + STAGES - 1);
    cp_async_commit();

    const int s = (j - jb) % STAGES;
    const int k0 = j * BK;
    // the block's keys below kmax: BK but in a block that straddles it
    const int kend = min(BK, kmax - k0);
    const float* Ks = smem_f32 + C::K_OFF + s * BK * C::KP;
    const float* Vs = smem_f32 + C::V_OFF + s * BK * C::VP;

    // S = Q K^T: TM x KN scores, 128-bit loads along d
    float sc[TM][KN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) sc[i][jj] = 0.f;
    if (kend == BK) {
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qr + i * C::RS * C::QP +
                                                  d);
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(
              Ks + (cg + G * jj) * C::KP + d);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            sc[i][jj] = fmaf(a[i].x, kk.x, sc[i][jj]);
            sc[i][jj] = fmaf(a[i].y, kk.y, sc[i][jj]);
            sc[i][jj] = fmaf(a[i].z, kk.z, sc[i][jj]);
            sc[i][jj] = fmaf(a[i].w, kk.w, sc[i][jj]);
          }
        }
      }
    } else if constexpr (C::CTAS > 2) {
      // a ragged block: only the score columns that hold a key below
      // kmax, a bound uniform across the CTA (the rest are masked); with
      // three CTAs an SM (168 registers a thread) the d loop stays rolled,
      // so this rare path holds few registers
      const int nj = (kend + G - 1) / G;
#pragma unroll 1
      for (int d = 0; d < D; d += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qr + i * C::RS * C::QP +
                                                  d);
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) {
          if (jj < nj) {
            const float4 kk = *reinterpret_cast<const float4*>(
                Ks + (cg + G * jj) * C::KP + d);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              sc[i][jj] = fmaf(a[i].x, kk.x, sc[i][jj]);
              sc[i][jj] = fmaf(a[i].y, kk.y, sc[i][jj]);
              sc[i][jj] = fmaf(a[i].z, kk.z, sc[i][jj]);
              sc[i][jj] = fmaf(a[i].w, kk.w, sc[i][jj]);
            }
          }
        }
      }
    } else {
      // the same with every loop unrolled
      const int nj = (kend + G - 1) / G;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        if (jj < nj) {
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(
                Ks + (cg + G * jj) * C::KP + d);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float4 a = *reinterpret_cast<const float4*>(
                  Qr + i * C::RS * C::QP + d);
              sc[i][jj] = fmaf(a.x, kk.x, sc[i][jj]);
              sc[i][jj] = fmaf(a.y, kk.y, sc[i][jj]);
              sc[i][jj] = fmaf(a.z, kk.z, sc[i][jj]);
              sc[i][jj] = fmaf(a.w, kk.w, sc[i][jj]);
            }
          }
        }
      }
    }

    // the mask runs only on blocks that straddle valid_len or the
    // diagonal; masked scores are -inf
    if (!(k0 + BK <= vlen && (!causal || k0 + BK - 1 <= q0))) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) {
          const int key = k0 + cg + G * jj;
          if (key >= vlen || (causal && key > row0 + C::RS * i))
            sc[i][jj] = -INFINITY;
        }
    }

    // online softmax in registers: the row max over the G lanes of the
    // row group by shuffles; the running max is finite (NEG), so a masked
    // score's exp2 is exactly 0 and a wholly masked block changes nothing
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int jj = 1; jj < KN; ++jj) mx = fmaxf(mx, sc[i][jj]);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(r.m[i], mx);
      const float alpha = ex2(r.m[i] - m_new);
      r.m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        sc[i][jj] = ex2(sc[i][jj] - m_new);
        sum += sc[i][jj];
      }
      r.l[i] = fmaf(r.l[i], alpha, sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) r.o[i][c] *= alpha;
    }
    // P as [key][row slot rg * TM + i], so P V reads the row group's TM
    // rows of a key as float4s
#pragma unroll
    for (int jj = 0; jj < KN; ++jj)
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        *reinterpret_cast<float4*>(Ps + (cg + G * jj) * C::PP + rg * TM +
                                   i) =
            make_float4(sc[i][jj], sc[i + 1][jj], sc[i + 2][jj],
                        sc[i + 3][jj]);
    __syncthreads();

    // O += P V over the block's first n keys: per key, TM / 4 loads of P
    // and NF4 (+ the tail) of V
    auto pv = [&](const int n) {
#pragma unroll 8
      for (int kk = 0; kk < n; ++kk) {
        float p[TM];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(
              Ps + kk * C::PP + rg * TM + i);
          p[i] = pp.x;
          p[i + 1] = pp.y;
          p[i + 2] = pp.z;
          p[i + 3] = pp.w;
        }
#pragma unroll
        for (int g = 0; g < NF4; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + kk * C::VP + 4 * (cg + G * g));
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            r.o[i][4 * g] = fmaf(p[i], vv.x, r.o[i][4 * g]);
            r.o[i][4 * g + 1] = fmaf(p[i], vv.y, r.o[i][4 * g + 1]);
            r.o[i][4 * g + 2] = fmaf(p[i], vv.z, r.o[i][4 * g + 2]);
            r.o[i][4 * g + 3] = fmaf(p[i], vv.w, r.o[i][4 * g + 3]);
          }
        }
#pragma unroll
        for (int t = 0; t < TAIL; ++t) {
          const float vv = Vs[kk * C::VP + 4 * G * NF4 + cg * TAIL + t];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            r.o[i][4 * NF4 + t] = fmaf(p[i], vv, r.o[i][4 * NF4 + t]);
        }
      }
    };
    // a ragged block's keys past kmax have P = 0: skipped
    if (kend == BK) {
      pv(BK);
    } else {
      pv(kend);
    }
  }
}

template <class C>
__device__ __forceinline__ void fma_clear(FmaRows<C>& r) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int c = 0; c < C::NC; ++c) r.o[i][c] = 0.f;
    r.m[i] = NEG;
    r.l[i] = 0.f;
  }
}

// The row sums of a thread's rows, over its row group.
template <class C>
__device__ __forceinline__ float fma_row_sum(const FmaRows<C>& r, int i) {
  float sum = r.l[i];
#pragma unroll
  for (int off = C::G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// A whole tile's output, normalized, into (B, T, H, D) memory; l == 0
// (every key masked) leaves O at 0.
template <class C>
__device__ __forceinline__ void fma_store(const FmaRows<C>& r,
                                          float* __restrict__ out, int b,
                                          int h, int heads, int tq, int q0) {
  constexpr int D = C::D, G = C::G, NF4 = C::NF4, TAIL = C::TAIL;
  const int rg = threadIdx.x / G;
  const int cg = threadIdx.x % G;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const float sum = fma_row_sum(r, i);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int t = q0 + rg + C::RS * i;
    if (t >= tq) continue;
    float* dst = out + ((static_cast<long long>(b) * tq + t) * heads + h) * D;
#pragma unroll
    for (int g = 0; g < NF4; ++g)
      *reinterpret_cast<float4*>(dst + 4 * (cg + G * g)) =
          make_float4(r.o[i][4 * g] * inv, r.o[i][4 * g + 1] * inv,
                      r.o[i][4 * g + 2] * inv, r.o[i][4 * g + 3] * inv);
#pragma unroll
    for (int t2 = 0; t2 < TAIL; ++t2)
      dst[4 * G * NF4 + cg * TAIL + t2] = r.o[i][4 * NF4 + t2] * inv;
  }
}

// One piece of a tile split between CTAs, unnormalized, into a slot of
// the workspace: m [BQ], l [BQ], then O [BQ][D], rows in tile order.
template <class C>
__device__ __forceinline__ void fma_store_piece(const FmaRows<C>& r,
                                                float* __restrict__ slot) {
  constexpr int D = C::D, G = C::G, BQ = C::BQ, NF4 = C::NF4;
  constexpr int TAIL = C::TAIL;
  const int rg = threadIdx.x / G;
  const int cg = threadIdx.x % G;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const float sum = fma_row_sum(r, i);
    const int row = rg + C::RS * i;
    if (cg == 0) {
      slot[row] = r.m[i];
      slot[BQ + row] = sum;
    }
    float* dst = slot + 2 * BQ + row * D;
#pragma unroll
    for (int g = 0; g < NF4; ++g)
      *reinterpret_cast<float4*>(dst + 4 * (cg + G * g)) =
          make_float4(r.o[i][4 * g], r.o[i][4 * g + 1], r.o[i][4 * g + 2],
                      r.o[i][4 * g + 3]);
#pragma unroll
    for (int t2 = 0; t2 < TAIL; ++t2)
      dst[4 * G * NF4 + cg * TAIL + t2] = r.o[i][4 * NF4 + t2];
  }
}

// The stream grid: the (b h, query tile, key block) units in that order,
// tile by tile, cut into n = gridDim.x equal runs, one a CTA: CTA c takes
// units [c U / n, (c + 1) U / n), U < 2^31 (the entry point checks). The
// CTA whose run holds unit x:
__device__ __forceinline__ int stream_cta(int x, int units, int n) {
  return static_cast<int>(
      ((x + 1LL) * n + units - 1) / units - 1);
}

// The float32 Fma tilings over a stream grid (D = 64). A CTA walks its
// run tile by tile; a tile wholly inside it is written as the tiles grid
// writes it, and a tile cut between CTAs leaves each CTA's piece (its m,
// l and unnormalized O) in the workspace, two slots a CTA (slot 0 its
// run's first tile, slot 1 its last). The CTA that adds the last piece to
// the tile's count (`arrived`, indexed by the CTA that holds the tile's
// first unit, zero at launch) merges every piece in order, so the bits do
// not depend on which CTA merges: out = sum_p f_p O_p / sum_p f_p l_p,
// f_p = 2^(m_p - max m). Index arithmetic is 32-bit, so the instance's
// three CTAs an SM keep every register (168 a thread).
template <class C>
__device__ __forceinline__ void fma_stream(
    float* smem_f32, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    const int* __restrict__ valid_len, Strides st, int batch, int heads,
    int tq, int tk, float scale_log2, float* __restrict__ part,
    int* __restrict__ arrived) {
  constexpr int BQ = C::BQ, BK = C::BK, D = C::D, D4 = C::D4;
  constexpr int SLOT = BQ * (D + 2);
  __shared__ int merges;
  const int tid = threadIdx.x;
  const int n = gridDim.x;
  const int c = blockIdx.x;
  const int tiles = (tq + BQ - 1) / BQ;
  const int nkmax = (tk + BK - 1) / BK;
  const int units = batch * heads * tiles * nkmax;
  const int u1 = static_cast<int>((c + 1LL) * units / n);
  FmaRows<C> r;
  bool first = true;
  for (int u = static_cast<int>(static_cast<long long>(c) * units / n);
       u < u1; first = false) {
    const int t = u / nkmax;  // (b h) * tiles + tile
    const int t0 = t * nkmax;
    const int jb = u - t0;
    const int je = min(t0 + nkmax, u1) - t0;
    u = t0 + je;
    const int bh = t / tiles;
    const int q0 = (t - bh * tiles) * BQ;
    const int b = bh / heads;
    const int h = bh - b * heads;
    int vlen = tk;
    if (valid_len != nullptr) vlen = min(max(valid_len[b], 0), tk);
    // blocks wholly past valid_len are never loaded
    const int nk = (vlen + BK - 1) / BK;
    fma_clear(r);
    if (jb < min(je, nk))
      fma_tile<C>(smem_f32, q, k, v, st, b, h, tq, vlen, q0, jb, min(je, nk),
                  scale_log2, 0, r);
    if (jb == 0 && je == nkmax) {
      fma_store(r, out, b, h, heads, tq, q0);
      continue;
    }
    // a piece: into slot 0 of this CTA if the tile is its run's first,
    // else slot 1; then counted, and the last of the tile's pieces merges
    fma_store_piece(r, part + (2LL * c + (first ? 0 : 1)) * SLOT);
    const int cf = stream_cta(t0, units, n);
    const int cl = stream_cta(t0 + nkmax - 1, units, n);
    __threadfence();
    __syncthreads();
    if (tid == 0) merges = atomicAdd(arrived + cf, 1) == cl - cf;
    __syncthreads();
    if (!merges) continue;
    __threadfence();
    // piece p is CTA cf + p's: slot 0, but CTA cf's slot 1 where the tile
    // is not the first of its run
    const int cf_tail = static_cast<long long>(cf) * units / n < t0;
    for (int e = tid; e < BQ * D4; e += C::THREADS) {
      const int row = e / D4;
      const int c4 = e - row * D4;
      if (q0 + row >= tq) continue;
      float mm = NEG;
      for (int p = cf; p <= cl; ++p) {
        const float* sl = part + (2LL * p + (p == cf ? cf_tail : 0)) * SLOT;
        mm = fmaxf(mm, __ldcg(sl + row));
      }
      float sum = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = cf; p <= cl; ++p) {
        const float* sl = part + (2LL * p + (p == cf ? cf_tail : 0)) * SLOT;
        const float f = ex2(__ldcg(sl + row) - mm);
        sum = fmaf(f, __ldcg(sl + BQ + row), sum);
        const float4 x = __ldcg(
            reinterpret_cast<const float4*>(sl + 2 * BQ + row * D) + c4);
        acc.x = fmaf(f, x.x, acc.x);
        acc.y = fmaf(f, x.y, acc.y);
        acc.z = fmaf(f, x.z, acc.z);
        acc.w = fmaf(f, x.w, acc.w);
      }
      const float w = sum > 0.f ? 1.f / sum : 0.f;
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(b) * tq + q0 + row) * heads + h) *
                    D +
          4 * c4) = make_float4(acc.x * w, acc.y * w, acc.z * w, acc.w * w);
    }
  }
}

// The tiles grid: blockIdx.x = b h, blockIdx.y the query tile; a causal
// grid launches its longest query tiles first.
template <class C>
__device__ __forceinline__ void fma_tiles(
    float* smem_f32, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    const int* __restrict__ valid_len, Strides st, int heads, int tq,
    int tk, float scale_log2, int causal) {
  constexpr int BQ = C::BQ, BK = C::BK;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * BQ;
  int vlen = tk;
  if (valid_len != nullptr) vlen = min(max(valid_len[b], 0), tk);
  // key blocks wholly past valid_len or above the causal diagonal are
  // never loaded: they would leave m, l and O unchanged
  int nk = (vlen + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  FmaRows<C> r;
  fma_clear(r);
  fma_tile<C>(smem_f32, q, k, v, st, b, h, tq, vlen, q0, 0, nk, scale_log2,
              causal, r);
  fma_store(r, out, b, h, heads, tq, q0);
}

// The split tiling (D = 128). Scoring and P V map the threads apart, so
// the score tile need not pay for O's registers: a thread scores TM = 4
// rows (rg + RS * i) against KN = BK / 8 keys (cg + 8 * jj; G = 8 lanes a
// row group, so one K load is one wavefront), then owns 8 P slots x 8
// columns of O. A P slot is 4 * rg + i, the row it holds rg + RS * i. P
// and each row's rescale alpha go through shared memory. Q's float4
// chunks are swizzled by the row's low two bits (chunk c of row r at
// c ^ (r & 3)), K's rows are D + 4 floats apart and P's chunks swizzled
// by the key (c ^ 2 (key & 3)), so a quarter-warp's loads hit distinct
// banks and every load address is a base register plus a constant. K
// and V blocks stream through a two-stage ring; each warp copies whole
// rows. The two CTAs of a cluster split a tile's key blocks: each runs
// its half, then each merges half of the tile's rows from both CTAs'
// shared memory (m, l and unnormalized O), so a grid has twice the CTAs
// and its last wave idles half as long.
template <int D_, int BQ_, int BK_>
struct FmaSplit {
  static constexpr bool SPLIT = true;
  static constexpr int D = D_, BQ = BQ_, BK = BK_;
  // one CTA an SM (__launch_bounds__): 128 rows fill its shared memory
  static constexpr int CTAS = 1;
  static constexpr int SPLITK = 2;  // CTAs a tile (a cluster)
  static constexpr int TM = 4, G = 8;
  static constexpr int RS = BQ / TM;      // row groups
  static constexpr int THREADS = RS * G;  // 2 BQ: a warp per 16 P slots
  static constexpr int NW = THREADS / 32;
  static constexpr int KN = BK / G;       // keys a thread scores
  static constexpr int D4 = D / 4;
  static constexpr int KP = D + 4;
  // shared memory in floats: Q [BQ][D], K [2][BK][KP], V [2][BK][D], P
  // [BK][BQ] and one float a row (alpha); the merge reuses K and V for O,
  // P for m and l
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * D;
  static constexpr int V_OFF = K_OFF + 2 * BK * KP;
  static constexpr int P_OFF = V_OFF + 2 * BK * D;
  static constexpr int A_OFF = P_OFF + BK * BQ;
  static constexpr int BYTES = (A_OFF + BQ) * sizeof(float);
  static_assert(D == 128, "O: two warps a 32-slot block, 64 columns each");
  static_assert(BQ % 32 == 0 && BK % 8 == 0 && BK % NW == 0, "tile shapes");
  static_assert(P_OFF - K_OFF >= BQ * D && BK >= 2, "room for the merge");
};

template <class C>
__device__ __forceinline__ void fma_split(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    const int* __restrict__ valid_len, Strides st, int heads, int tq,
    int tk, float scale_log2, int causal) {
  constexpr int D = C::D, BQ = C::BQ, BK = C::BK, KN = C::KN, D4 = C::D4;
  constexpr int RS = C::RS, NW = C::NW, KP = C::KP;
  float* const Ps = smem + C::P_OFF;
  float* const As = smem + C::A_OFF;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // a cluster's CTAs are blockIdx.y 2 t and 2 t + 1; causal: the longest
  // query tiles are launched first
  const int rank = static_cast<int>(blockIdx.y & 1);
  const int tiles = gridDim.y / 2;
  const int tile = causal ? tiles - 1 - blockIdx.y / 2 : blockIdx.y / 2;
  const int q0 = tile * BQ;
  const int qt = static_cast<int>(st.qt);
  const int kt = static_cast<int>(st.kt);
  const int vt = static_cast<int>(st.vt);
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  int vlen = tk;
  if (valid_len != nullptr) vlen = min(max(valid_len[b], 0), tk);
  // key blocks wholly past valid_len or above the causal diagonal are
  // never loaded: they would leave m, l and O unchanged; rank 0 takes the
  // first half of the rest, rank 1 the second
  int nk = (vlen + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  const int jb = rank == 0 ? 0 : (nk + 1) / 2;
  const int je = rank == 0 ? (nk + 1) / 2 : nk;

  // K and V of block j into stage s: warp w copies rows w + NW n, a lane
  // a 16-byte chunk; keys at or past valid_len (and so past T) are
  // zero-filled, and the mask decides what counts
  auto load_kv = [&](int j, int s) {
    const int k0 = j * BK;
    const float* ks = kp + static_cast<long long>(k0) * st.kt + 4 * lane;
    const float* vs = vp + static_cast<long long>(k0) * st.vt + 4 * lane;
    const uint32_t kd = base + (C::K_OFF + s * BK * KP + 4 * lane) * 4;
    const uint32_t vd = base + (C::V_OFF + s * BK * D + 4 * lane) * 4;
#pragma unroll
    for (int n = 0; n < BK / NW; ++n) {
      const int r = warp + NW * n;
      const bool in = k0 + r < vlen;
      cp_async16(kd + r * KP * 4, in ? ks + r * kt : k, in ? 16u : 0u);
      cp_async16(vd + r * D * 4, in ? vs + r * vt : v, in ? 16u : 0u);
    }
  };
  if (jb < je) load_kv(jb, 0);
  cp_async_commit();

  // Q (swizzled), scaled by scale*log2(e) so the softmax takes exp2 of
  // the scores; rows past T are 0
  {
    const float* qp = q + b * st.qb + h * st.qh +
                      static_cast<long long>(q0) * st.qt + 4 * lane;
#pragma unroll 4
    for (int n = 0; n < BQ / NW; ++n) {
      const int r = warp + NW * n;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < tq) {
        x = __ldg(reinterpret_cast<const float4*>(qp + r * qt));
        x.x *= scale_log2;
        x.y *= scale_log2;
        x.z *= scale_log2;
        x.w *= scale_log2;
      }
      *reinterpret_cast<float4*>(smem + C::Q_OFF + r * D +
                                 4 * (lane ^ (r & 3))) = x;
    }
  }

  // scoring: row group rg, lane cg; rows rg + RS * i share rg's swizzle,
  // so chunk 4 c4 + u of each is at qb[u] + 16 c4 (+ i RS D)
  const int rg = tid / 8;
  const int cg = tid % 8;
  const int row0 = q0 + rg;
  const float* qb[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    qb[u] = smem + C::Q_OFF + rg * D + 4 * (u ^ (rg & 3));
  // P V: P slots 8 ro .. 8 ro + 7 (row groups 2 ro and 2 ro + 1), columns
  // col + 32 g + e; a warp holds 32 slots x 64 columns
  const int ro = (warp >> 1) * 4 + (lane >> 3);
  const int col = 64 * (warp & 1) + 4 * (lane & 7);

  float o[8][8];  // o[s][4 g + e]
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[s][c] = 0.f;
  float m[4], l[4];  // l: this lane's part of the row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }

  for (int j = jb; j < je; ++j) {
    const int k0 = j * BK;
    const int s = (j - jb) & 1;
    const float* Kr = smem + C::K_OFF + s * BK * KP + cg * KP;
    const float* Vs = smem + C::V_OFF + s * BK * D;
    // block j has landed for every thread, and every thread is done with
    // block j - 1: its stage, P and alpha may be overwritten
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < je) load_kv(j + 1, s ^ 1);
    cp_async_commit();

    // S = Q K^T: 4 x KN scores, 128-bit loads along d
    float sc[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) sc[i][jj] = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < D4 / 4; ++c4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qb[u] + i * RS * D +
                                                  16 * c4);
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(
              Kr + 8 * jj * KP + 16 * c4 + 4 * u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[i][jj] = fmaf(a[i].x, kk.x, sc[i][jj]);
            sc[i][jj] = fmaf(a[i].y, kk.y, sc[i][jj]);
            sc[i][jj] = fmaf(a[i].z, kk.z, sc[i][jj]);
            sc[i][jj] = fmaf(a[i].w, kk.w, sc[i][jj]);
          }
        }
      }
    }

    // the mask runs only on blocks that straddle valid_len or the
    // diagonal; masked scores are -inf
    if (!(k0 + BK <= vlen && (!causal || k0 + BK - 1 <= q0))) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) {
          const int key = k0 + cg + 8 * jj;
          if (key >= vlen || (causal && key > row0 + RS * i))
            sc[i][jj] = -INFINITY;
        }
    }

    // online softmax in registers, the row max over the 8 lanes of the
    // row group; the running max is finite (NEG), so a masked score's
    // exp2 is exactly 0 and a wholly masked block changes nothing
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int jj = 1; jj < KN; ++jj) mx = fmaxf(mx, sc[i][jj]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        sc[i][jj] = ex2(sc[i][jj] - m_new);
        sum += sc[i][jj];
      }
      l[i] = fmaf(l[i], alpha[i], sum);
    }
    // P [key][slot]: the 4 slots of row group rg are chunk rg
#pragma unroll
    for (int jj = 0; jj < KN; ++jj)
      *reinterpret_cast<float4*>(Ps + (cg + 8 * jj) * BQ +
                                 4 * (rg ^ (2 * (cg & 3)))) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    if (cg == 0)
      *reinterpret_cast<float4*>(As + 4 * rg) =
          make_float4(alpha[0], alpha[1], alpha[2], alpha[3]);
    __syncthreads();

    // O = alpha O + P V: per key two float4s of P (chunks 2 ro and
    // 2 ro + 1, swizzled by an even value, so still adjacent) and two of V
    {
      const float4 a0 = *reinterpret_cast<const float4*>(As + 8 * ro);
      const float4 a1 = *reinterpret_cast<const float4*>(As + 8 * ro + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[t][c] *= al[t];
    }
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float* pr = Ps + kk * BQ + 4 * ((2 * ro) ^ (2 * (kk & 3)));
      const float4 p0 = *reinterpret_cast<const float4*>(pr);
      const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + kk * D + col);
      const float4 v1 =
          *reinterpret_cast<const float4*>(Vs + kk * D + col + 32);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        o[t][0] = fmaf(p[t], v0.x, o[t][0]);
        o[t][1] = fmaf(p[t], v0.y, o[t][1]);
        o[t][2] = fmaf(p[t], v0.z, o[t][2]);
        o[t][3] = fmaf(p[t], v0.w, o[t][3]);
        o[t][4] = fmaf(p[t], v1.x, o[t][4]);
        o[t][5] = fmaf(p[t], v1.y, o[t][5]);
        o[t][6] = fmaf(p[t], v1.z, o[t][6]);
        o[t][7] = fmaf(p[t], v1.w, o[t][7]);
      }
    }
  }

  // the row sums over the row group; every thread is done with K, V, P
  // and alpha
  __syncthreads();
  float lsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lsum[i] = l[i];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);
  }
  // m, l and unnormalized O of this CTA's half into shared memory, then
  // rank r merges slots [r BQ / 2, (r + 1) BQ / 2) of both halves:
  // out = (f0 O0 + f1 O1) / (f0 l0 + f1 l1), f = 2^(m - max(m0, m1))
  float* const Ms = smem + C::P_OFF;
  float* const Ls = Ms + BQ;
  float* const Os = smem + C::K_OFF;
  if (cg == 0) {
    *reinterpret_cast<float4*>(Ms + 4 * rg) =
        make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(Ls + 4 * rg) =
        make_float4(lsum[0], lsum[1], lsum[2], lsum[3]);
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float* dst = Os + (8 * ro + t) * D + col;
    *reinterpret_cast<float4*>(dst) =
        make_float4(o[t][0], o[t][1], o[t][2], o[t][3]);
    *reinterpret_cast<float4*>(dst + 32) =
        make_float4(o[t][4], o[t][5], o[t][6], o[t][7]);
  }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const unsigned peer = static_cast<unsigned>(rank ^ 1);
  const float* Mp = cluster.map_shared_rank(Ms, peer);
  const float* Lp = cluster.map_shared_rank(Ls, peer);
  const float* Op = cluster.map_shared_rank(Os, peer);
#pragma unroll 4
  for (int e = tid; e < BQ / 2 * D4; e += C::THREADS) {
    const int slot = rank * (BQ / 2) + e / D4;
    const int c = e % D4;
    const int row = q0 + (slot >> 2) + RS * (slot & 3);
    if (row >= tq) continue;
    const float m0 = Ms[slot], m1 = Mp[slot];
    const float mm = fmaxf(m0, m1);
    const float f0 = ex2(m0 - mm), f1 = ex2(m1 - mm);
    const float sum = f0 * Ls[slot] + f1 * Lp[slot];
    const float w = sum > 0.f ? 1.f / sum : 0.f;
    const float4 x = *reinterpret_cast<const float4*>(Os + slot * D + 4 * c);
    const float4 y = *reinterpret_cast<const float4*>(Op + slot * D + 4 * c);
    *reinterpret_cast<float4*>(
        out + ((static_cast<long long>(b) * tq + row) * heads + h) * D +
        4 * c) = make_float4((f0 * x.x + f1 * y.x) * w,
                             (f0 * x.y + f1 * y.y) * w,
                             (f0 * x.z + f1 * y.z) * w,
                             (f0 * x.w + f1 * y.w) * w);
  }
  // the peer may still be reading this CTA's shared memory
  cluster.sync();
}

// STREAM: the stream grid (fma_stream; Fma tilings, not causal), else
// the tiles grid.
template <class C, bool STREAM>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 const int* __restrict__ valid_len, Strides st, int batch,
                 int heads, int tq, int tk, float scale_log2, int causal,
                 float* __restrict__ part, int* __restrict__ arrived) {
  extern __shared__ __align__(16) float smem_f32[];
  if constexpr (C::SPLIT) {
    fma_split<C>(smem_f32, q, k, v, out, valid_len, st, heads, tq, tk,
                 scale_log2, causal);
  } else if constexpr (STREAM) {
    fma_stream<C>(smem_f32, q, k, v, out, valid_len, st, batch, heads, tq,
                  tk, scale_log2, part, arrived);
  } else {
    fma_tiles<C>(smem_f32, q, k, v, out, valid_len, st, heads, tq, tk,
                 scale_log2, causal);
  }
}

// the float32 tilings: Fma<D, TM, G, BQ, BK, STAGES[, CTAs an SM = 2]>
// and FmaSplit<D, BQ, BK> (one CTA an SM, a tile on a cluster of two);
// the stream grid's FmaD64S takes 32-key blocks, so three CTAs (60 KB of
// shared memory each) share an SM
using FmaD64 = Fma<64, 4, 8, 64, 64, 2>;
using FmaD64S = Fma<64, 4, 8, 64, 32, 2, 3>;
using FmaD72 = Fma<72, 4, 8, 64, 64, 2>;
using FmaD80 = Fma<80, 4, 8, 64, 56, 2>;
using FmaD128 = FmaSplit<128, 128, 64>;

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device, once: `done` (one per kernel instance) holds a bit per device
// whose limit is already raised, so later launches skip the host call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Raise the float32 instance's shared-memory limit, once per device.
template <class C, bool STREAM>
cudaError_t prepare_f32() {
  static std::atomic<uint64_t> smem_raised{0};
  return allow_smem(flash_fma_kernel<C, STREAM>, C::BYTES, smem_raised);
}

// The float32 launch on the stream grid of `ctas` CTAs, `work` holding
// 2 ctas slots of BQ (D + 2) floats and then ctas ints, which this launch
// zeroes. Refused (cudaErrorNotSupported) when causal, or unless
// 1 <= ctas <= units < 2^31 (a tile's pieces come from every CTA between
// the ones that hold its first and last unit).
template <class C>
cudaError_t launch_stream(const void* q, const void* k, const void* v,
                          void* out, const int* valid_len, const Strides& st,
                          int batch, int heads, int tq, int tk, float scale,
                          int causal, int ctas, void* work,
                          cudaStream_t stream) {
  const long long units = static_cast<long long>(batch) * heads *
                          ((tq + C::BQ - 1) / C::BQ) *
                          ((tk + C::BK - 1) / C::BK);
  if (causal || ctas < 1 || ctas > units || units >= (1LL << 31) ||
      work == nullptr)
    return cudaErrorNotSupported;
  float* part = static_cast<float*>(work);
  int* arrived =
      reinterpret_cast<int*>(part + 2LL * ctas * C::BQ * (C::D + 2));
  cudaError_t err = prepare_f32<C, true>();
  if (err == cudaSuccess)
    err = cudaMemsetAsync(arrived, 0, sizeof(int) * ctas, stream);
  if (err != cudaSuccess) return err;
  flash_fma_kernel<C, true><<<ctas, C::THREADS, C::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), valid_len, st,
      batch, heads, tq, tk, scale * LOG2E, 0, part, arrived);
  return cudaGetLastError();
}

// The float32 launch on the tiles grid.
template <class C>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, const int* valid_len, const Strides& st,
                       int batch, int heads, int tq, int tk, float scale,
                       int causal, cudaStream_t stream) {
  const float sl = scale * LOG2E;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const int tiles = (tq + C::BQ - 1) / C::BQ;
  if (tiles * C::SPLITK > 65535) return cudaErrorInvalidValue;
  cudaError_t err = prepare_f32<C, false>();
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, tiles * C::SPLITK);
  if constexpr (C::SPLITK > 1) {
    // a tile's CTAs form a cluster (blockIdx.y 2 t and 2 t + 1)
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = C::SPLITK;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(C::THREADS);
    cfg.dynamicSmemBytes = C::BYTES;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    float* none = nullptr;
    int* no_count = nullptr;
    err = cudaLaunchKernelEx(&cfg, flash_fma_kernel<C, false>, qf, kf, vf,
                             of, valid_len, st, batch, heads, tq, tk, sl,
                             causal, none, no_count);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  flash_fma_kernel<C, false><<<grid, C::THREADS, C::BYTES, stream>>>(
      qf, kf, vf, of, valid_len, st, batch, heads, tq, tk, sl, causal,
      nullptr, nullptr);
  return cudaGetLastError();
}

// An instance's shape (head dim, query rows and keys a tile, threads,
// dynamic shared memory, CTAs a tile) and how many of its CTAs fit an SM
// of the current device (the occupancy calculator's answer) against how
// many its design declares (its __launch_bounds__).
template <class C, bool STREAM>
int fma_info(int* vals) {
  cudaError_t err = prepare_f32<C, STREAM>();
  if (err != cudaSuccess) return static_cast<int>(err);
  vals[0] = C::D;
  vals[1] = C::BQ;
  vals[2] = C::BK;
  vals[3] = C::THREADS;
  vals[4] = C::BYTES;
  vals[5] = C::SPLITK;
  vals[7] = C::CTAS;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      vals + 6, flash_fma_kernel<C, STREAM>, C::THREADS, C::BYTES));
}

// ----------------------------------------------------------- bfloat16

constexpr int WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int BQ16 = 2 * WG_ROWS;        // query rows per CTA
constexpr int CONSUMERS = 2 * 128;       // two consumer warpgroups
constexpr int THREADS16 = CONSUMERS + 32;  // and one producer warp
constexpr int ROW_BYTES = 128;           // a swizzled row: 64 bf16
constexpr int TAIL_ROW = 16;             // a tail row: 8 bf16

// Shared memory (bytes from a 1024-aligned base): the Q tile, the K and V
// rings of STAGES blocks of BK keys, the tails of D = 72 (unswizzled,
// 16-byte rows), a zero block the tails' second k8 half reads, and the
// mbarriers.
template <int D, int STAGES, int BK>
struct Smem16 {
  static constexpr int CHUNKS = D / 64;  // 64-wide swizzled parts
  static constexpr int TAIL = D % 64;    // 0 or 8
  static_assert(TAIL == 0 || TAIL == 8, "D must be 64 * n or 64 * n + 8");
  static_assert(BK == 64 || BK == 128, "a key block is 64 or 128 keys");
  static constexpr int Q_CHUNK = BQ16 * ROW_BYTES;
  static constexpr int KV_CHUNK = BK * ROW_BYTES;
  static constexpr int KV_STAGE = CHUNKS * KV_CHUNK;
  static constexpr int Q_TAIL = TAIL ? BQ16 * TAIL_ROW : 0;
  static constexpr int KV_TAIL = TAIL ? BK * TAIL_ROW : 0;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + CHUNKS * Q_CHUNK;
  static constexpr int V_OFF = K_OFF + STAGES * KV_STAGE;
  static constexpr int QT_OFF = V_OFF + STAGES * KV_STAGE;
  static constexpr int KT_OFF = QT_OFF + Q_TAIL;
  static constexpr int VT_OFF = KT_OFF + STAGES * KV_TAIL;
  static constexpr int Z_OFF = VT_OFF + STAGES * KV_TAIL;
  // the tails' k 8..15 for up to 128 rows (Q's 64 per warpgroup, K's BK)
  static constexpr int Z_BYTES = TAIL ? 128 * TAIL_ROW : 0;
  static constexpr int BAR_OFF = Z_OFF + Z_BYTES;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static constexpr uint32_t Q_TX = CHUNKS * Q_CHUNK + Q_TAIL;
  static constexpr uint32_t KV_TX = KV_STAGE + KV_TAIL;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait of more
// than ~2^34 clocks (seconds) can only be a fault in the pipeline: it
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// one box of a 4-d tensor map (d, token, head, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int t0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(t0),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout (1 = 128-byte swizzle,
// 0 = none)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t swizzle128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle128) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait that ends it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, accumulate);
  } else {
    wgmma_ss_n64(d, desc_a, desc_b, accumulate);
  }
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 8] += A[64 x 16] B[16 x 8], A in registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S (+)= Q K^T over one key block: CHUNKS x 4 k16 steps over the swizzled
// 64-wide parts (a k16 step is 32 bytes into a 128-byte row), and for
// D = 72 one more over the tails, whose k 8..15 half is the zero block.
template <int D, int STAGES, int BK>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             uint32_t base, int wg, int s) {
  using L = Smem16<D, STAGES, BK>;
  const uint32_t qa = base + L::Q_OFF + wg * WG_ROWS * ROW_BYTES;
  const uint32_t ka = base + L::K_OFF + s * L::KV_STAGE;
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BK>(sc, desc(qa + c * L::Q_CHUNK + 32 * kk, 16, 1024, 1),
                   desc(ka + c * L::KV_CHUNK + 32 * kk, 16, 1024, 1),
                   c + kk > 0);
  if constexpr (L::TAIL != 0) {
    const uint32_t zero = base + L::Z_OFF;
    const uint32_t qt = base + L::QT_OFF + wg * WG_ROWS * TAIL_ROW;
    const uint32_t kt = base + L::KT_OFF + s * L::KV_TAIL;
    // K-major, unswizzled: 8-row core matrices 128 bytes apart (SBO), the
    // second k8 half at LBO (the zero block)
    wgmma_ss<BK>(sc, desc(qt, zero - qt, 128, 0),
                 desc(kt, zero - kt, 128, 0), 1);
  }
}

// O += P V over one key block: per k16 step, one n64 per 64-wide part of
// V (MN-major, 8-key groups 1024 bytes apart) and for D = 72 one n8 over
// the tail (MN-major, unswizzled: 8-key groups 128 bytes apart).
template <int D, int STAGES, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 64][32],
                                         float (&ot)[4],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t base, int s) {
  using L = Smem16<D, STAGES, BK>;
  const uint32_t va = base + L::V_OFF + s * L::KV_STAGE;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c)
      wgmma_rs_n64(o[c], p[kk],
                   desc(va + c * L::KV_CHUNK + kk * 16 * ROW_BYTES,
                        L::KV_CHUNK, 1024, 1));
    if constexpr (L::TAIL != 0) {
      const uint32_t vt = base + L::VT_OFF + s * L::KV_TAIL;
      wgmma_rs_n8(ot, p[kk], desc(vt + kk * 16 * TAIL_ROW, 128,
                                  BK * TAIL_ROW, 0));
    }
  }
}

// Online softmax of one score block in registers. A thread holds rows
// `row` and `row + 8` of its warp's 16, columns 8g + col0 + {0, 1} for
// g < BK / 8: sc[4g + e] is row + 8 * (e >> 1), column 8g + col0 + (e & 1).
// sc becomes exp2 of the scaled scores less the running max m, and l
// gathers the thread's part of the row sums. The max moves only when a
// row's grows by more than 8 in log2 units (P then stays below 256, well
// inside bfloat16's range), so most blocks skip rescaling O: the function
// returns whether it moved in any row of the warp, and then alpha holds
// each row's rescale factor for O.
template <int BK>
__device__ __forceinline__ bool softmax_block(float (&sc)[BK / 2],
                                              float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], bool masked,
                                              int key0, int vlen, int causal,
                                              int row, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int g = 0; g < BK / 8; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * g + (e & 1);
        if (key >= vlen || (causal && key > row + 8 * (e >> 1)))
          sc[4 * g + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int g = 0; g < BK / 8; ++g) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * g], sc[4 * g + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * g + 2], sc[4 * g + 3]));
  }
  bool grow = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    grow = grow || (mx[i] - m[i]) * scale_log2 > 8.f;
  }
  const bool moved = __any_sync(0xffffffffu, grow);
  if (moved) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = ex2((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
  }
  // masked scores are -inf and the running max is finite, so their
  // exp2 is exactly 0
  const float b0 = -m[0] * scale_log2;
  const float b1 = -m[1] * scale_log2;
#pragma unroll
  for (int g = 0; g < BK / 8; ++g) {
    sc[4 * g] = ex2(fmaf(sc[4 * g], scale_log2, b0));
    sc[4 * g + 1] = ex2(fmaf(sc[4 * g + 1], scale_log2, b0));
    sc[4 * g + 2] = ex2(fmaf(sc[4 * g + 2], scale_log2, b1));
    sc[4 * g + 3] = ex2(fmaf(sc[4 * g + 3], scale_log2, b1));
    l[0] += sc[4 * g] + sc[4 * g + 1];
    l[1] += sc[4 * g + 2] + sc[4 * g + 3];
  }
  return moved;
}

// P in bfloat16 as wgmma's register A operand: for the k16 step kk, the
// score groups 2kk and 2kk + 1 (rows row / row + 8, keys k and k + 8).
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int D, int STAGES, int BK>
__global__ void __launch_bounds__(THREADS16, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap q_tail,
                   const __grid_constant__ CUtensorMap k_tail,
                   const __grid_constant__ CUtensorMap v_tail,
                   __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ valid_len, int heads, int tq,
                   int tk, float scale_log2, int causal) {
  using L = Smem16<D, STAGES, BK>;
  constexpr int CH = L::CHUNKS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_full = [=](int s) { return bars + 8u * (1 + s); };
  auto v_full = [=](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_empty = [=](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [=](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * BQ16;
  int vlen = tk;
  if (valid_len != nullptr) vlen = min(max(valid_len[b], 0), tk);
  // key blocks past valid_len, or above the causal diagonal, are never
  // loaded: they would leave m, l and O unchanged
  int nk = (vlen + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ16 - 1) / BK + 1);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS / 32);
      mbar_init(v_empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (L::TAIL != 0) {
    uint4* zero = reinterpret_cast<uint4*>(smem_raw + (base - raw) + L::Z_OFF);
    for (int i = tid; i < L::Z_BYTES / 16; i += THREADS16)
      zero[i] = make_uint4(0u, 0u, 0u, 0u);
    // the zero block is read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one lane issues every copy
    if (tid == CONSUMERS && nk > 0) {
      mbar_expect_tx(q_full, L::Q_TX);
      for (int c = 0; c < CH; ++c)
        tma_load(base + L::Q_OFF + c * L::Q_CHUNK, &q_map, q_full, 64 * c,
                 q0, h, b);
      if constexpr (L::TAIL != 0)
        tma_load(base + L::QT_OFF, &q_tail, q_full, 64 * CH, q0, h, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        // the release of this stage's previous block completes phase
        // (j / STAGES - 1) of its empty barrier
        const uint32_t prev = static_cast<uint32_t>(j / STAGES + 1) & 1u;
        const int k0 = j * BK;
        if (j >= STAGES) mbar_wait(k_empty(s), prev);
        mbar_expect_tx(k_full(s), L::KV_TX);
        for (int c = 0; c < CH; ++c)
          tma_load(base + L::K_OFF + s * L::KV_STAGE + c * L::KV_CHUNK,
                   &k_map, k_full(s), 64 * c, k0, h, b);
        if constexpr (L::TAIL != 0)
          tma_load(base + L::KT_OFF + s * L::KV_TAIL, &k_tail, k_full(s),
                   64 * CH, k0, h, b);
        if (j >= STAGES) mbar_wait(v_empty(s), prev);
        mbar_expect_tx(v_full(s), L::KV_TX);
        for (int c = 0; c < CH; ++c)
          tma_load(base + L::V_OFF + s * L::KV_STAGE + c * L::KV_CHUNK,
                   &v_map, v_full(s), 64 * c, k0, h, b);
        if constexpr (L::TAIL != 0)
          tma_load(base + L::VT_OFF + s * L::KV_TAIL, &v_tail, v_full(s),
                   64 * CH, k0, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns CTA rows [64 wg, 64 wg + 64); this thread
  // holds rows `row` and `row + 8` (global indices) of its warp's 16
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row = q0 + wg * WG_ROWS + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int wg_row0 = q0 + wg * WG_ROWS;

  float o[CH][32];  // O's columns 64c.., and ot the tail's 8
  float ot[4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ot[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float sc[BK / 2];
  uint32_t p[BK / 16][4];

  auto masked = [=](int j) {
    const int k0 = j * BK;
    return !(k0 + BK <= vlen && (!causal || k0 + BK - 1 <= wg_row0));
  };
  // Ping-pong: the warpgroups take turns to issue their products (named
  // barrier 1 + wg is this warpgroup's turn), so one runs its softmax
  // while the other's products hold the tensor cores. Each issues nk + 1
  // times; warpgroup 1 opens the first turn of warpgroup 0 and does not
  // pass after its last.
  auto take_turn = [=]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMERS)
                 : "memory");
  };
  auto pass_turn = [=](bool last) {
    if (!(last && wg == 1))
      asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMERS)
                   : "memory");
  };

  if (nk > 0) {
    if (wg == 1) pass_turn(false);
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    take_turn();
    wgmma_fence();
    issue_scores<D, STAGES, BK>(sc, base, wg, 0);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    hold(sc);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_block<BK>(sc, m, l, alpha, masked(0), col0, vlen, causal, row,
                      scale_log2);
  }
  for (int j = 1; j < nk; ++j) {
    // P of block j-1 goes to the tensor cores with the scores of block j;
    // the exponentials of block j then run while P V is in flight
    const int s = j % STAGES;
    const int sp = (j - 1) % STAGES;
    pack_p<BK>(p, sc);
    mbar_wait(k_full(s), static_cast<uint32_t>(j / STAGES) & 1u);
    mbar_wait(v_full(sp), static_cast<uint32_t>((j - 1) / STAGES) & 1u);
    take_turn();
    wgmma_fence();
    issue_scores<D, STAGES, BK>(sc, base, wg, s);
    wgmma_commit();
    issue_pv<D, STAGES, BK>(o, ot, p, base, sp);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<1>();  // the scores of block j
    hold(sc);
    if (lane == 0) mbar_arrive(k_empty(s));
    const bool moved =
        softmax_block<BK>(sc, m, l, alpha, masked(j), j * BK + col0, vlen,
                          causal, row, scale_log2);
    wgmma_wait<0>();  // P V of block j-1
#pragma unroll
    for (int c = 0; c < CH; ++c) hold(o[c]);
    hold(ot);
    hold(p);
    if (lane == 0) mbar_arrive(v_empty(sp));
    if (moved) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) ot[i] *= alpha[(i >> 1) & 1];
    }
  }
  if (nk > 0) {
    const int sp = (nk - 1) % STAGES;
    pack_p<BK>(p, sc);
    mbar_wait(v_full(sp), static_cast<uint32_t>((nk - 1) / STAGES) & 1u);
    take_turn();
    wgmma_fence();
    issue_pv<D, STAGES, BK>(o, ot, p, base, sp);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < CH; ++c) hold(o[c]);
    hold(ot);
    hold(p);
  }

  // the row sums over the four lanes of a fragment row; l == 0 (every key
  // masked) leaves O at 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row + 8 * half;
    if (t >= tq) continue;
    // (B, T, H, D) output
    __nv_bfloat16* dst =
        out + ((static_cast<long long>(b) * tq + t) * heads + h) * D + col0;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * c + 8 * g) =
            __floats2bfloat162_rn(o[c][4 * g + 2 * half] * inv[half],
                                  o[c][4 * g + 2 * half + 1] * inv[half]);
    if constexpr (L::TAIL != 0)
      *reinterpret_cast<__nv_bfloat162*>(dst + 64 * CH) =
          __floats2bfloat162_rn(ot[2 * half] * inv[half],
                                ot[2 * half + 1] * inv[half]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library links no driver library
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map (d, token, head, batch) over a strided bfloat16 tensor whose
// boxes are box_d x box_t, with the 128-byte swizzle or none.
bool make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
              int t, int heads, int batch, long long sb, long long sh,
              long long st, int box_d, int box_t, bool swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d),
                             static_cast<cuuint32_t>(box_t), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int STAGES, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, const int* valid_len, const Strides& st,
                        int batch, int heads, int tq, int tk, float scale,
                        int causal, cudaStream_t stream) {
  using L = Smem16<D, STAGES, BK>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, qt, kt, vt;
  bool ok = make_map(fn, &qm, q, D, tq, heads, batch, st.qb, st.qh, st.qt,
                     64, BQ16, true) &&
            make_map(fn, &km, k, D, tk, heads, batch, st.kb, st.kh, st.kt,
                     64, BK, true) &&
            make_map(fn, &vm, v, D, tk, heads, batch, st.vb, st.vh, st.vt,
                     64, BK, true);
  if (L::TAIL != 0) {
    ok = ok &&
         make_map(fn, &qt, q, D, tq, heads, batch, st.qb, st.qh, st.qt,
                  L::TAIL, BQ16, false) &&
         make_map(fn, &kt, k, D, tk, heads, batch, st.kb, st.kh, st.kt,
                  L::TAIL, BK, false) &&
         make_map(fn, &vt, v, D, tk, heads, batch, st.vb, st.vh, st.vt,
                  L::TAIL, BK, false);
  } else {
    qt = qm;
    kt = km;
    vt = vm;
  }
  if (!ok) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_raised{0};
  cudaError_t err = allow_smem(flash_wgmma_kernel<D, STAGES, BK>, L::ALLOC,
                               smem_raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ16 - 1) / BQ16, batch * heads);
  flash_wgmma_kernel<D, STAGES, BK>
      <<<grid, THREADS16, L::ALLOC, stream>>>(
      qm, km, vm, qt, kt, vt, static_cast<__nv_bfloat16*>(out), valid_len,
      heads, tq, tk, scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Tq, D), k/v (B, H, Tk, D) of one dtype (dtype_kind 0 =
// float32, 1 = bfloat16), each read through strides[0..8] = its (batch,
// head, token) element strides for q, k, v in turn, unit stride in D (for
// bfloat16 the byte strides and base addresses must be multiples of 16,
// TMA's rule; the caller checks). out: (B, Tq, H, D) contiguous.
// valid_len: (B,) int32 device array or null (every key valid). D must be
// 64, 72 or 128, or 80 in float32. grid: 0 the tiles grid, or 1 (float32
// D = 64, not causal) the stream grid of `ctas` CTAs (FmaD64S) with its
// workspace `work` (2 ctas BQ (D + 2) floats, then ctas ints); the
// caller's launch rule picks it (ops/flash_attention.py fma_grid), and a
// grid the instance does not have returns cudaErrorNotSupported. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int oar_flash_attention(const void* q, const void* k,
                                   const void* v, void* out,
                                   const void* valid_len, int dtype_kind,
                                   int batch, int heads, int tq, int tk,
                                   int d, const long long* strides,
                                   float scale, int causal, int grid,
                                   int ctas, void* work, void* stream) {
  const long long bh = static_cast<long long>(batch) * heads;
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0 || bh > 65535 ||
      strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid < 0 || grid > 1 ||
      (grid == 1 && !(dtype_kind == 0 && d == 64))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // bfloat16 <D, STAGES, BK>: at D = 72 four stages of 128 keys (165 KB of
  // shared memory), and D = 64 (no tail) the same ring; at D = 128 three
  // of 64, so S, P and O fit in registers
  if (grid == 1) {
    err = launch_stream<FmaD64S>(q, k, v, out, vl, st, batch, heads, tq,
                                 tk, scale, causal, ctas, work, s);
  } else if (dtype_kind == 0 && d == 64) {
    err = launch_f32<FmaD64>(q, k, v, out, vl, st, batch, heads, tq, tk,
                             scale, causal, s);
  } else if (dtype_kind == 0 && d == 72) {
    err = launch_f32<FmaD72>(q, k, v, out, vl, st, batch, heads, tq, tk,
                             scale, causal, s);
  } else if (dtype_kind == 0 && d == 80) {
    err = launch_f32<FmaD80>(q, k, v, out, vl, st, batch, heads, tq, tk,
                             scale, causal, s);
  } else if (dtype_kind == 0 && d == 128) {
    err = launch_f32<FmaD128>(q, k, v, out, vl, st, batch, heads, tq, tk,
                              scale, causal, s);
  } else if (dtype_kind == 1 && d == 64) {
    err = launch_bf16<64, 4, 128>(q, k, v, out, vl, st, batch, heads, tq, tk,
                                  scale, causal, s);
  } else if (dtype_kind == 1 && d == 72) {
    err = launch_bf16<72, 4, 128>(q, k, v, out, vl, st, batch, heads, tq, tk,
                                  scale, causal, s);
  } else if (dtype_kind == 1 && d == 128) {
    err = launch_bf16<128, 3, 64>(q, k, v, out, vl, st, batch, heads, tq,
                                  tk, scale, causal, s);
  }
  return static_cast<int>(err);
}

// The float32 instances by index (0, 1, ...): the name of instance i, or
// null past the last.
extern "C" const char* oar_flash_fma_name(int i) {
  static const char* const names[] = {"FmaD64 tiles", "FmaD64S stream",
                                      "FmaD72 tiles", "FmaD80 tiles",
                                      "FmaD128 tiles"};
  return i >= 0 && i < 5 ? names[i] : nullptr;
}

// Instance i's vals[8]: head dim, query rows a tile, keys a block,
// threads a CTA, dynamic shared-memory bytes, CTAs a tile, CTAs of it that
// fit on one SM of the current device (the occupancy calculator's answer)
// and CTAs an SM its design declares (its __launch_bounds__). Returns a
// cudaError_t (0 on success).
extern "C" int oar_flash_fma_info(int i, int* vals) {
  switch (i) {
    case 0:
      return fma_info<FmaD64, false>(vals);
    case 1:
      return fma_info<FmaD64S, true>(vals);
    case 2:
      return fma_info<FmaD72, false>(vals);
    case 3:
      return fma_info<FmaD80, false>(vals);
    case 4:
      return fma_info<FmaD128, false>(vals);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
