// One-token (decode) attention over a paged KV cache: the device code of
// kernel 7 (pool_decode_attention.cu), its only user. Kernels 3 and 9 (the
// dense cache) run decode_attention_dense.cuh.
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
//  - fold (fused_decode_attention.cu): query row b attends the STALE prefix,
//    slots j < offset[b], plus the current token's k/v, which arrive as
//    separate (B, Hkv, D) inputs and are folded into the online softmax as
//    one more slot: in the single chunk after its last tile, else in the
//    combine kernel. With a write requested, the first chunk's block of each
//    (row, kv head) also stores k/v at slot offset[b] of the caches, in place,
//    on rows whose write mask is set; no block of the launch reads that slot.
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

// The current token of the fold form: k/v (B, Hkv, D); with ``write`` they
// are also stored at slot offset[b] of k_out / v_out (the dense caches) on
// rows whose write_mask (B,) is non-zero (null: every row).
struct Fold {
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  __nv_bfloat16* k_out;
  __nv_bfloat16* v_out;
  const uint8_t* write_mask;
  int write;
};

// lc[g] = (scaled q of head g) . k_new for the block's G query heads; q in
// shared memory as fp32 with the scale folded in, k_new the kv head's row.
template <int G>
__device__ __forceinline__ void fold_logits(const float* qs, const __nv_bfloat16* kn,
                                            float* lc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += kThreads / 32) {
    float s = 0.0f;
#pragma unroll
    for (int d = lane; d < kD; d += 32) s += qs[g * kD + d] * __bfloat162float(kn[d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) lc[g] = s;
  }
  __syncthreads();
}

template <int G, bool PAGED, bool FOLD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,    // (B, H, D)
                        const Cache c,
                        const int32_t* __restrict__ offs, int off_scalar,
                        __nv_bfloat16* __restrict__ out,        // (B, H, D)
                        float* __restrict__ part,  // chunk partials, null for one chunk
                        int Hkv, float scale, int chunk, const Fold f) {
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
  const int live = FOLD ? off : off + 1;   // fold: the current token is not in the cache
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

  if constexpr (FOLD) {
    // the row write: slot `off` is outside every chunk of this launch
    if (f.write && blockIdx.z == 0 && (f.write_mask == nullptr || f.write_mask[b] != 0)) {
      const size_t src = ((size_t)b * Hkv + kvh) * kD + tid;
      const size_t dst = (((size_t)b * c.S + off) * Hkv + kvh) * kD + tid;
      f.k_out[dst] = f.k_new[src];
      f.v_out[dst] = f.v_new[src];
    }
  }

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
    if constexpr (FOLD) {   // the current token as the last slot
      __shared__ float lc[G];
      const size_t row = ((size_t)b * Hkv + kvh) * kD;
      fold_logits<G>(qs, f.k_new + row, lc);
      const float vn = __bfloat162float(f.v_new[row + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m_new = fmaxf(m_s[g], lc[g]);
        const float corr = __expf(m_s[g] - m_new), p = __expf(lc[g] - m_new);
        out[((size_t)b * H + (size_t)kvh * G + g) * kD + tid] =
            __float2bfloat16_rn((acc[g] * corr + p * vn) / (l_s[g] * corr + p));
      }
      return;
    }
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

// Rescales each chunk to the common max and sums them in chunk order. The
// fold form adds the current token (q, k_new, v_new) as one more slot.
template <int G, bool FOLD>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                                int Hkv, int nsplit, const __nv_bfloat16* __restrict__ q,
                                float scale, const Fold f) {
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t rows = (size_t)gridDim.y * Hkv * nsplit * G;
  const float* pm = part + rows * kD;
  const float* pl = pm + rows;
  const size_t base = ((size_t)b * Hkv + kvh) * nsplit * G;
  __shared__ __align__(16) float qs[FOLD ? G * kD : 1];
  __shared__ float lc[G];
  float vn = 0.0f;
  if constexpr (FOLD) {
    for (int i = tid; i < G * kD; i += kThreads)
      qs[i] = __bfloat162float(q[((size_t)b * Hkv * G + (size_t)kvh * G) * kD + i]) * scale;
    __syncthreads();
    const size_t row = ((size_t)b * Hkv + kvh) * kD;
    fold_logits<G>(qs, f.k_new + row, lc);
    vn = __bfloat162float(f.v_new[row + tid]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = FOLD ? lc[g] : -INFINITY;
    for (int c = 0; c < nsplit; ++c) mx = fmaxf(mx, pm[base + (size_t)c * G + g]);
    float num = 0.0f, den = 0.0f;
    if constexpr (FOLD) {
      num = __expf(lc[g] - mx) * vn;
      den = __expf(lc[g] - mx);
    }
    for (int c = 0; c < nsplit; ++c) {
      const size_t r = base + (size_t)c * G + g;
      const float w = __expf(pm[r] - mx);   // 0 for an empty chunk
      num += w * part[r * kD + tid];
      den += w * pl[r];
    }
    out[((size_t)b * Hkv * G + (size_t)kvh * G + g) * kD + tid] = __float2bfloat16_rn(num / den);
  }
}

template <int G, bool PAGED, bool FOLD>
cudaError_t launch_g(const void* q, const Cache& c, const void* offs, int off_scalar, void* out,
                     void* part, int B, int Hkv, float scale, int nsplit, int chunk,
                     const Fold& f, cudaStream_t stream) {
  float* p = nsplit > 1 ? static_cast<float*>(part) : nullptr;
  decode_attention_kernel<G, PAGED, FOLD><<<dim3(Hkv, B, nsplit), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), c, static_cast<const int32_t*>(offs), off_scalar,
      static_cast<__nv_bfloat16*>(out), p, Hkv, scale, nsplit > 1 ? chunk : c.S, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_attention_combine_kernel<G, FOLD><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      p, static_cast<__nv_bfloat16*>(out), Hkv, nsplit, static_cast<const __nv_bfloat16*>(q),
      scale, f);
  return cudaGetLastError();
}

// nsplit > 1 splits the slots into chunks of `chunk` (a multiple of 64) and
// needs `part`: B * Hkv * nsplit * G * (D + 2) floats. FOLD needs f.k_new and
// f.v_new (and, with f.write, f.k_out and f.v_out).
template <bool PAGED, bool FOLD = false>
cudaError_t launch(const void* q, const Cache& c, const void* offs, int off_scalar, void* out,
                   void* part, int B, int Hkv, int G, int D, float scale, int nsplit, int chunk,
                   cudaStream_t st, const Fold& f = Fold{}) {
  if (D != kD || B < 1 || c.S < 1 || Hkv < 1 || nsplit < 1 ||
      (nsplit > 1 && (part == nullptr || chunk < 1 || chunk % kTile != 0)) ||
      (FOLD && (f.k_new == nullptr || f.v_new == nullptr ||
                (f.write && (f.k_out == nullptr || f.v_out == nullptr)))))
    return cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch_g<1, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 2: return launch_g<2, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 3: return launch_g<3, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 4: return launch_g<4, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 5: return launch_g<5, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 6: return launch_g<6, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 7: return launch_g<7, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    case 8: return launch_g<8, PAGED, FOLD>(q, c, offs, off_scalar, out, part, B, Hkv, scale, nsplit, chunk, f, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gptq_attn
