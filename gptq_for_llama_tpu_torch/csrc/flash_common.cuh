// Causal prefill attention on bf16 tensor cores, shared by kernel 5
// (flash_prefill.cu: no cache, SQ == SKV, offset 0) and kernel 4
// (flash_prefill_blocked.cu: a chunk of SQ queries at a cache offset).
//
// q (B, SQ, H, D), k/v (B, SKV, Hkv, D), bf16, D = 128. Query row i sits at
// absolute position q_offset + i and attends cache slots j <= q_offset + i,
// j < SKV; query head h reads kv head h / (H / Hkv). Logits are fp32 (bf16
// q and k, fp32 accumulation) times scale, the softmax is fp32, and p is
// rounded to bf16 before p @ v, which accumulates in fp32: the TPU kernels'
// operand types (gptq_for_llama_tpu/ops/pallas/flash.py:103-118). The TPU
// kernels normalize p before the cast; here the online softmax divides the
// fp32 accumulator at the end.
//
// What bounds it on the H100: operations, once a chunk holds a few hundred
// queries (B = 8, S = 2048, H = 32 is 275 GFLOP of causal work per layer
// against 134 MB, 0.28 ms at 989 TFLOP/s); for a short chunk over a short
// live prefix, bytes.
// Design (the TPU kernels keep a head's whole K/V in VMEM; an SM has no such
// room: 512 KB at S = 2048):
//  - one block of 4 warps per (64-query tile, head, batch row); each warp
//    owns 16 query rows; the heaviest (last) query tiles are launched first;
//  - K/V stream through shared memory in 64-key tiles with cp.async: V(t) is
//    fetched while S = Q K(t)^T is computed, K(t+1) while P V(t) is;
//  - both products are mma.sync.m16n8k16 bf16 with fp32 accumulators; Q's
//    fragments stay in registers; P goes from the S accumulators straight to
//    A fragments (the m16n8 C layout is the m16k16 A layout);
//  - running max and denominator in fp32 per row; key tiles wholly above the
//    tile's causal limit (q_offset + its last row) are never loaded; the
//    diagonal and the ragged last tile are masked, rows past SQ and slots
//    past the causal limit are zero-filled (a cache may hold NaN there), so
//    any SQ, SKV and offset works (the TPU kernels
//    need SQ % 128 == 0 with an offset, S % 256 == 0 without).
// OFFSET = false compiles the offset out (kernel 5: SQ == SKV, offset 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace gptq_flash {

using namespace gptq_mma;

constexpr int kD = 128;
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kD + 8;          // bf16 per smem row: 272 B, conflict-free ldmatrix
constexpr int kTile = kBQ * kStride;     // elements of one 64 x 128 tile
constexpr int kSmemBytes = 3 * kTile * 2;  // Q, K, V: 52,224 B
constexpr float kNeg = -1e30f;           // running-max start: finite, so exp never sees inf - inf

// rows [row0, row0 + 64) of a (.., S, heads, D) tensor into a padded smem tile;
// rows >= S are zero-filled
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          size_t row_stride, int row0, int S, int tid) {
#pragma unroll
  for (int c = tid; c < kBQ * (kD / 8); c += kThreads) {
    const int r = c >> 4, c8 = (c & 15) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * kStride + c8, base + (size_t)(ok ? row0 + r : 0) * row_stride + c8, ok);
  }
}

// grid: (ceil(SQ / kBQ), H, B); block: kThreads; dynamic smem: kSmemBytes
template <bool OFFSET>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q,   // (B, SQ, H, D)
             const __nv_bfloat16* __restrict__ k,   // (B, SKV, Hkv, D)
             const __nv_bfloat16* __restrict__ v,   // (B, SKV, Hkv, D)
             __nv_bfloat16* __restrict__ out,       // (B, SQ, H, D)
             int SQ, int SKV, int H, int Hkv, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kTile;
  __nv_bfloat16* vs = ks + kTile;

  const int off = OFFSET ? q_offset : 0;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const size_t q_stride = (size_t)H * kD, kv_stride = (size_t)Hkv * kD;
  const __nv_bfloat16* qbase = q + ((size_t)b * SQ * H + h) * kD;
  const __nv_bfloat16* kbase = k + ((size_t)b * SKV * Hkv + kvh) * kD;
  const __nv_bfloat16* vbase = v + ((size_t)b * SKV * Hkv + kvh) * kD;

  // keys up to the causal limit of the tile's last real row; slots past it
  // are never read (zero-filled), so a cache may hold anything there
  const int kv_end = min(SKV, off + min(q0 + kBQ, SQ));
  const int n_kt = (kv_end - 1) / kBK + 1;
  load_tile(qs, qbase, q_stride, q0, SQ, tid);
  load_tile(ks, kbase, kv_stride, 0, kv_end, tid);
  cp_async_commit();
  const int row_lo = q0 + warp * 16 + g;               // this thread's two rows
  const int row_hi = row_lo + 8;
  const int pos_lo = off + row_lo, pos_hi = off + row_hi;   // their absolute positions

  uint32_t qf[kD / 16][4];
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.0f, l_hi = 0.0f;   // l: this thread's partial sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();   // K(kt) (and Q) landed; every warp is done with V(kt-1)
    load_tile(vs, vbase, kv_stride, k0, kv_end, tid);
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                            kk * 16 + (lane >> 4) * 8);
    }

    // s = q k^T: 16 rows x 64 keys per warp
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, causal / ragged mask, online softmax
    const bool masked = (k0 + kBK - 1 > off + q0) || (k0 + kBK > SKV);
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        const int pos = e < 2 ? pos_lo : pos_hi;
        float x = s[n][e] * scale;
        if (masked && (key > pos || key >= SKV)) x = -INFINITY;
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = __expf(m_lo - mn_lo), a_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = __expf(s[n][0] - mn_lo);
      s[n][1] = __expf(s[n][1] - mn_lo);
      s[n][2] = __expf(s[n][2] - mn_hi);
      s[n][3] = __expf(s[n][3] - mn_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }
    // p as bf16 A fragments: keys 16j..16j+15 are n-tiles 2j and 2j+1
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      pf[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }

    cp_async_wait_all();
    __syncthreads();   // V(kt) landed; every warp is done with K(kt)
    if (kt + 1 < n_kt) {
      load_tile(ks, kbase, kv_stride, k0 + kBK, kv_end, tid);
      cp_async_commit();
    }

    // o += p v: 16 rows x 128 dims per warp
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                              dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pf[j], bf[0], bf[1]);
        mma16816(o[2 * dp + 1], pf[j], bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
  }
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
  if (row_lo < SQ) {
    __nv_bfloat16* orow = out + ((size_t)b * SQ + row_lo) * q_stride + (size_t)h * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
  }
  if (row_hi < SQ) {
    __nv_bfloat16* orow = out + ((size_t)b * SQ + row_hi) * q_stride + (size_t)h * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
}

// One launch; sets the dynamic shared memory attribute once per instantiation
// (not per launch, so a CUDA-graph capture sees none).
template <bool OFFSET>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int SQ,
                   int SKV, int H, int Hkv, int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_kernel<OFFSET>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((SQ + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), SQ, SKV, H, Hkv,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace gptq_flash
