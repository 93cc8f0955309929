// One-token (decode) attention over a KV cache: the device code shared by the
// dense entry (decode_attention.cu) and the paged entry
// (pool_decode_attention.cu).
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:_attn_kernel and
// :_attn_kernel_gqa, reached through decode_attention (dense cache) and
// pool_decode_attention (block pool). Semantics: query row b attends cache
// slots j <= offset[b] (the current token's k/v are already written at
// slot offset[b]), softmax in fp32 — the same function as the plain
// version, attention.py:_xla_decode_fallback. In the paged form slot j of
// row b lives at pool[tables[b, j / BS], j % BS].
//
// What bounds it on the H100: device-memory bytes of the LIVE cache prefix
// (2 * (offset+1) * Hkv * D * 2 B per row: 0.63 us at 128 live slots and
// 10 us at 2048 for 7B's 32 heads, at 3.35 TB/s). Design:
//  - one block per (batch row, kv head) serves that head's G query heads, so
//    a GQA cache row is read once for all G heads (the plain version repeats
//    it G times);
//  - the block loops over 64-slot tiles up to offset[b] only: bytes follow
//    the live prefix, not the cache length;
//  - K and V tiles are staged in shared memory with 16-byte coalesced loads
//    (the K tile padded by 16 B per row so the per-slot dot products read
//    conflict-free); logits, the running max / denominator and the output
//    accumulator stay in fp32 (online softmax, as the TPU kernel).
//  - one block per (batch row, kv head) is only 32 blocks for 7B at batch 1:
//    a long live prefix is split into chunks of whole tiles, one block per
//    chunk, each writing its unnormalized (max, denominator, accumulator);
//    a small second kernel rescales and sums the chunks in order. Short
//    prefixes (one chunk) take the single pass and write the output directly.
//    The split is planned on the host from a bound on the live length; the
//    last chunk runs to the row's own offset, so a row past that bound is
//    still read in full.
//  - paged: no gathered logical view is built. Per tile the block reads the
//    few entries of its row of the block table that the tile spans (each
//    needed entry once, none past offset[b] / BS) and addresses the pool
//    through them; a kv head's row inside a physical block is a 256 B piece
//    at a stride of Hkv * D * 2 bytes, loaded by 16 threads of 16 bytes as
//    in the dense cache. Slots past offset[b] and blocks the row does not
//    own are never loaded.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gptq_attn {

constexpr int kD = 128;
constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kKStride = kD + 8;   // padded bf16 row stride of the K tile
constexpr int kMinBlock = 8;       // smallest pool block size (slots)
constexpr int kTabMax = kTile / kMinBlock + 1;   // table entries one tile can span

// Where the cache lives. Dense: (B, S, Hkv, D), tables null. Paged: pools
// (NB, BS, Hkv, D) and tables (B, MB) int32; S is then the logical length
// MB * BS.
struct Cache {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* tables;
  int S, NB, BS, MB;
};

template <int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,    // (B, H, D)
                        const Cache c,
                        const int32_t* __restrict__ offs, int off_scalar,
                        __nv_bfloat16* __restrict__ out,        // (B, H, D)
                        float* __restrict__ part,  // chunk partials, null for one chunk
                        int Hkv, float scale, int chunk) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kD];
  __shared__ __align__(16) float qs[G * kD];
  __shared__ float ps[G][kTile];
  __shared__ float alpha_s[G], m_s[G], l_s[G];
  __shared__ int tab_s[kTabMax];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = Hkv * G;
  const int tid = threadIdx.x;
  int off = offs != nullptr ? offs[b] : off_scalar;
  off = min(max(off, 0), c.S - 1);
  const int live = off + 1;
  const int t_begin = blockIdx.z * chunk;        // this block's slots
  const int t_end = blockIdx.z == gridDim.z - 1 ? live : min(live, t_begin + chunk);

  // this kv head's G query heads are contiguous in (B, H, D); fold the scale in
  for (int i = tid; i < G * kD; i += kThreads)
    qs[i] = __bfloat162float(q[((size_t)b * H + (size_t)kvh * G) * kD + i]) * scale;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  float acc[G];   // output dim d = tid of each query head
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;

  const size_t row_stride = (size_t)Hkv * kD;   // elements between cache slots
  const size_t base = (PAGED ? (size_t)0 : (size_t)b * c.S * row_stride) + (size_t)kvh * kD;
  const __nv_bfloat16* kbase = c.k + base;
  const __nv_bfloat16* vbase = c.v + base;
  const int warp = tid >> 5, lane = tid & 31;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int n = min(kTile, t_end - t0);
    __syncthreads();   // the previous tile's readers are done
    const int blk0 = PAGED ? t0 / c.BS : 0;   // first logical block of the tile
    if (PAGED) {
      const int nent = (t0 + n - 1) / c.BS - blk0 + 1;
      if (tid < nent) {
        const int phys = c.tables[(size_t)b * c.MB + blk0 + tid];
        tab_s[tid] = min(max(phys, 0), c.NB - 1);
      }
      __syncthreads();
    }
    for (int i = tid; i < kTile * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c8 = (i % (kD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        size_t slot = (size_t)(t0 + r);
        if (PAGED) {
          const int lb = (t0 + r) / c.BS;
          slot = (size_t)tab_s[lb - blk0] * c.BS + (size_t)((t0 + r) - lb * c.BS);
        }
        kv = *reinterpret_cast<const uint4*>(kbase + slot * row_stride + c8);
        vv = *reinterpret_cast<const uint4*>(vbase + slot * row_stride + c8);
      }
      *reinterpret_cast<uint4*>(ks + r * kKStride + c8) = kv;
      *reinterpret_cast<uint4*>(vs + r * kD + c8) = vv;
    }
    __syncthreads();

    // logits: one (head, slot) pair per thread and step
    for (int pi = tid; pi < G * kTile; pi += kThreads) {
      const int g = pi / kTile, j = pi % kTile;
      float s = -INFINITY;
      if (j < n) {
        const float* qg = qs + g * kD;
        const __nv_bfloat16* kr = ks + j * kKStride;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
        for (int d = 0; d < kD; d += 8) {
          const uint4 u = *reinterpret_cast<const uint4*>(kr + d);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
          const float4 qa = *reinterpret_cast<const float4*>(qg + d);
          const float4 qb = *reinterpret_cast<const float4*>(qg + d + 4);
          const float2 k0 = __bfloat1622float2(k2[0]), k1 = __bfloat1622float2(k2[1]);
          const float2 k2f = __bfloat1622float2(k2[2]), k3 = __bfloat1622float2(k2[3]);
          s0 += qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y;
          s1 += qb.x * k2f.x + qb.y * k2f.y + qb.z * k3.x + qb.w * k3.y;
        }
        s = s0 + s1;
      }
      ps[g][j] = s;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = ps[g][lane], cc = ps[g][lane + 32];
      float mx = fmaxf(a, cc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);   // finite: every tile holds a live slot
      const float pa = __expf(a - m_new), pc = __expf(cc - m_new);
      ps[g][lane] = pa;
      ps[g][lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float al = __expf(m_old - m_new);
        alpha_s[g] = al;
        l_s[g] = l_s[g] * al + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= alpha_s[g];
    for (int j = 0; j < n; ++j) {
      const float v = __bfloat162float(vs[j * kD + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += ps[g][j] * v;
    }
  }

  if (part == nullptr) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      out[((size_t)b * H + (size_t)kvh * G + g) * kD + tid] =
          __float2bfloat16_rn(acc[g] / l_s[g]);
    return;
  }
  // chunk partials: acc rows, then max, then denominator (an empty chunk
  // writes -inf / 0 / 0; thread g wrote m_s[g] and l_s[g] itself in that case)
  const size_t rows = (size_t)gridDim.y * Hkv * gridDim.z * G;
  const size_t row0 = (((size_t)b * Hkv + kvh) * gridDim.z + blockIdx.z) * G;
#pragma unroll
  for (int g = 0; g < G; ++g) part[(row0 + g) * kD + tid] = acc[g];
  if (tid < G) {
    part[rows * kD + row0 + tid] = m_s[tid];
    part[rows * kD + rows + row0 + tid] = l_s[tid];
  }
}

// Rescales each chunk to the common max and sums them in chunk order.
template <int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                                int Hkv, int nsplit) {
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t rows = (size_t)gridDim.y * Hkv * nsplit * G;
  const float* pm = part + rows * kD;
  const float* pl = pm + rows;
  const size_t base = ((size_t)b * Hkv + kvh) * nsplit * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int c = 0; c < nsplit; ++c) mx = fmaxf(mx, pm[base + (size_t)c * G + g]);
    float num = 0.0f, den = 0.0f;
    for (int c = 0; c < nsplit; ++c) {
      const size_t r = base + (size_t)c * G + g;
      const float w = __expf(pm[r] - mx);   // 0 for an empty chunk
      num += w * part[r * kD + tid];
      den += w * pl[r];
    }
    out[((size_t)b * Hkv * G + (size_t)kvh * G + g) * kD + tid] = __float2bfloat16_rn(num / den);
  }
}

template <int G, bool PAGED>
cudaError_t launch_g(const void* q, const Cache& c, const void* offs, int off_scalar, void* out,
                     void* part, int B, int Hkv, float scale, int nsplit, int chunk,
                     cudaStream_t stream) {
  float* p = nsplit > 1 ? static_cast<float*>(part) : nullptr;
  decode_attention_kernel<G, PAGED><<<dim3(Hkv, B, nsplit), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), c, static_cast<const int32_t*>(offs), off_scalar,
      static_cast<__nv_bfloat16*>(out), p, Hkv, scale, nsplit > 1 ? chunk : c.S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_attention_combine_kernel<G><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      p, static_cast<__nv_bfloat16*>(out), Hkv, nsplit);
  return cudaGetLastError();
}

// nsplit > 1 splits the slots into chunks of `chunk` (a multiple of 64) and
// needs `part`: B * Hkv * nsplit * G * (D + 2) floats.
template <bool PAGED>
cudaError_t launch(const void* q, const Cache& c, const void* offs, int off_scalar, void* out,
                   void* part, int B, int Hkv, int G, int D, float scale, int nsplit, int chunk,
                   cudaStream_t st) {
  if (D != kD || B < 1 || c.S < 1 || Hkv < 1 || nsplit < 1 ||
      (nsplit > 1 && (part == nullptr || chunk < 1 || chunk % kTile != 0)))
    return cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch_g<1, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 2: return launch_g<2, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 3: return launch_g<3, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 4: return launch_g<4, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 5: return launch_g<5, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 6: return launch_g<6, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 7: return launch_g<7, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    case 8: return launch_g<8, PAGED>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gptq_attn
