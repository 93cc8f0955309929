// One-token (decode) attention over a KV cache, for Hopper: the body of
// kernel 3 (decode_attention.cu), of kernel 9, its fold form
// (fused_decode_attention.cu), and of kernel 7, its paged form
// (pool_decode_attention.cu).
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:_attn_kernel and
// :_attn_kernel_gqa (entries decode_attention and pool_decode_attention) and
// :_fused_attn_kernel (entry fused_decode_attention). Semantics: query row b attends cache slots
// j < live[b], softmax in fp32; live[b] = offset[b] + 1 for kernel 3 (the
// current token is already written at slot offset[b]) and offset[b] for the
// fold form, which adds the current token's k/v (separate (B, Hkv, D) inputs)
// as one more slot and, with a write requested, stores them at slot
// offset[b] on rows whose write mask is set. The same functions as the plain
// versions (ops/cuda/attention.py).
//
// The cache is stored in bf16, f32, fp8-e4m3 or fp8-e5m2 (the template
// parameter T, kv_dtype.cuh) and read in that type: the ring holds the stored
// bytes and each K/V element upcasts to fp32 as the TPU kernels' _load_f32
// does (e4m3 by integer bit math, codes 0x7F / 0xFF read as +-480). q and the
// fold form's current k/v stay bf16; the fold form rounds its current k/v to
// the cache type before it attends them, as the TPU wrapper passes
// k_new.astype(cache dtype) (ops/pallas/attention.py:378), and writes that
// value as JAX's astype would (kv_dtype.cuh: an e4m3 overflow is NaN).
//
// What bounds it on the H100: device-memory bytes of the LIVE cache prefix,
// 2 * live * Hkv * D * itemsize B per row: in bf16 10.0 us at 2048 live slots
// of 7B's 32 heads at 3.35 TB/s (5.0 in fp8, 20.0 in f32), 1.97 us for the GQA
// row (B = 2, Hkv = 8, offsets 100 and 1500), 0.63 us at 128 slots. The
// arithmetic is 4 flops per bf16 byte. So the design keeps bytes in flight on
// every SM and puts nothing in series with the copies:
//  - a block serves one (batch row, kv head, chunk of live slots) and that
//    head's G query heads, so a GQA cache row is read once for all G heads.
//    The host plan (ops/cuda/attention.py:decode_plan) fits the grid into one
//    wave of resident blocks with chunks of 64-192 slots; a prefix of at most
//    128 slots is one chunk and one pass with no combine. The last chunk runs
//    to the row's own live bound, so a row past the bound the plan was made
//    for is still read in full; a block whose chunk starts past its row's
//    bound exits at once.
//  - K and V stream through a 4-stage ring in dynamic shared memory (64 KB in
//    bf16 and three blocks per SM; 32 KB in fp8; 128 KB in f32, one block per
//    SM) with 16-byte cp.async.cg copies (8 bf16, 16 fp8 or 4 f32 elements
//    each): a block issues four
//    32-slot tiles before it computes the first, so a 128-slot chunk is in
//    flight at once, and refills a stage as soon as it is read. Each warp
//    copies and reads only its own 8 slots of every tile, so a tile needs no
//    block barrier: cp.async.wait_group and __syncwarp. The block's only
//    barrier is the merge at its end.
//  - slots at or past the live bound are never read from device memory: the
//    copy zero-fills their K and V rows (src-size 0) and their logits are
//    -inf. So the output does not depend on what they hold (NaN, or the fold
//    form's row write landing in the same launch).
//  - paged (kernel 7): slot j of row b lives at pool[tables[b, j / BS],
//    j % BS], pools (NB, BS, Hkv, D) with BS % 8 == 0, so a warp's 8 slots of
//    a tile lie in one physical block and one table entry routes the warp's
//    copy. Each warp loads the entries of its next 32 tiles once (lane l the
//    entry of tile l), before it issues the ring, and takes each from its
//    lane with a shuffle; a slice wholly at or past the live bound never
//    reads its entry (past offset[b] / BS an entry may hold anything). The
//    arithmetic is kernel 3's, in the same order under the same plan, so
//    kernel 7 over a pool equals kernel 3 over the gathered view bit for bit.
//  - per-warp online softmax in log2 units (scale * log2(e) folded into q,
//    one ex2 per logit), merged once across the four warps at the end of the
//    block, on CUDA cores: a lane holds 4 output dims of each 128-dim group
//    for all G heads, and the 8 logits of a warp's slice are reduced with a
//    transposing butterfly (9 shuffles a head for 8 slots, not 40).
//  - the head dim D is a template parameter (64, 80, 96, 128, 256; one
//    library per D, built with -DGPTQ_HEAD_DIM). Lane l holds dims
//    128 v + 4 l .. + 3 of group v < ceil(D / 128); at D = 64, 80 and 96
//    lanes 16, 20 and 24 on hold none (their q is zero and they read no
//    K or V), at D = 256 each lane holds two groups. Every row is a whole
//    number of 16-byte copies (80 bf16 is 10, 80 fp8 is 5). The ring keeps
//    4 stages up to 128 KB and fewer above (an f32 cache at D = 256: 2);
//    D = 256 sizes its registers for 2 blocks an SM. At D = 128 the
//    arithmetic is the same, in the same order, as with D fixed at 128.
//  - chunk partials (unnormalized accumulator, max, denominator) go to a
//    second kernel, not to a counter and a last block: it rescales and sums
//    the chunks of each (row, kv head) in chunk order, so two runs are
//    bit-equal. It is a programmatic dependent launch: its blocks start while
//    the chunk grid runs, load what does not depend on it, and wait
//    (griddepcontrol.wait) only to read the partials. The fold form adds its
//    current token there, or after the single chunk's merge.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_dtype.cuh"
#include "mma_sync.cuh"

#ifndef GPTQ_HEAD_DIM
#define GPTQ_HEAD_DIM 128
#endif
#define GPTQ_HD_NS2(d) hd##d
#define GPTQ_HD_NS(d) GPTQ_HD_NS2(d)

// Every name of this header is in an inline namespace of the head dim (see
// flash_common.cuh): libraries of two head dims share no symbol.
namespace gptq_dense {
inline namespace GPTQ_HD_NS(GPTQ_HEAD_DIM) {

using gptq_mma::cp_async16;
using gptq_mma::cp_async_commit;
using gptq_mma::cp_async_wait;
using gptq_mma::cp_async_wait_all;

constexpr int kHeadDim = GPTQ_HEAD_DIM;   // the head dim this library is built for
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpSlots = 8;                     // slots of a tile one warp copies and reads
constexpr int kTile = kWarps * kWarpSlots;        // 32 cache slots per ring stage
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 128 * 1024;           // ring bytes the stages are fitted under
constexpr int kMaxSplit = 64;                     // chunks per row the combine stages
constexpr float kLog2e = 1.4426950408889634f;

// The layout of one head dim D over a cache of element type T
template <int D, typename T>
struct Dims {
  static_assert(D % 16 == 0 && D >= 64 && D <= 256, "head dim: a multiple of 16 in 64..256");
  static constexpr int kGroups = (D + 127) / 128;        // 4-dim groups a lane holds
  static constexpr int kPasses = (D + kThreads - 1) / kThreads;   // output dims a thread
  static constexpr int kSliceElems = kWarpSlots * D;     // one warp's K (or V) rows of a stage
  static constexpr int kStageBytes = kWarps * 2 * kSliceElems * (int)sizeof(T);
  static constexpr int kStages = kRingBudget / kStageBytes < kMaxStages
                                     ? kRingBudget / kStageBytes : kMaxStages;
  // bytes of the ring: [warp][stage][K | V][slot][D]: 64 KB in bf16 at D = 128
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static constexpr int kE = 16 / (int)sizeof(T);         // elements a 16-byte copy
  static constexpr int kRowCopies = D / kE;              // 16-byte copies a cache row
  static constexpr int kCopies = kWarpSlots * kRowCopies;   // a warp's copies of K per tile
  static_assert(D % kE == 0, "a cache row must be whole 16-byte copies");
  static_assert(kStages >= 2, "the ring needs two stages");
};
// resident blocks the registers are sized for
template <int D>
constexpr int kBlocksPerSm = D <= 128 ? 3 : 2;
// lane's dims of group v: 128 v + 4 lane .. + 3, all inside D or none
template <int D>
__device__ __forceinline__ bool group_live(int v, int lane) {
  return 128 * v + 4 * lane < D;
}

// The current token of the fold form: k/v (B, Hkv, D) bf16; with ``write``
// they are also stored, encoded in the cache type T, at slot offset[b] of
// k_out / v_out (the caches) on rows whose write_mask (B,) is non-zero (null:
// every row).
template <typename T>
struct Fold {
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  T* k_out;
  T* v_out;
  const uint8_t* write_mask;
  int write;
};

// The fold form's current k/v element as it attends it: rounded to the cache
// type and read back (exact for bf16 and f32)
template <typename T>
__device__ __forceinline__ float fold_value(__nv_bfloat16 x) {
  using KV = gptq_kv::Kv<T>;
  return KV::to_float(KV::encode(x));
}
template <typename T>
__device__ __forceinline__ void fold_load4(const __nv_bfloat16* p, float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = fold_value<T>(p[i]);
}

// The block tables of the paged form: (B, MB) int32, BS slots per block.
struct Pages {
  const int32_t* tables;
  int BS, MB;
};

// 2^x, the MUFU's approximation; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bf16x4(uint2 u, float (&f)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ float dot4(const float (&a)[4], const float (&b)[4]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

// q of the G heads of kv head kvh, row b, scaled, as this lane's groups
template <int D, int G>
__device__ __forceinline__ void load_q(const __nv_bfloat16* q, size_t head0, float qscale,
                                       int lane, float (&qr)[G][Dims<D, float>::kGroups][4]) {
  constexpr int kGroups = Dims<D, float>::kGroups;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int v = 0; v < kGroups; ++v) {
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (group_live<D>(v, lane))
        bf16x4(*reinterpret_cast<const uint2*>(q + (head0 + g) * D + 128 * v + 4 * lane), t);
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[g][v][i] = t[i] * qscale;
    }
}

// Programmatic dependent launch (PTX griddepcontrol): the chunk kernel lets
// the combine kernel be scheduled once every chunk block has started; the
// combine waits for the whole chunk grid (and its memory) before it reads.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A load through L2 that the compiler keeps after the wait above: the
// partials are written by the chunk grid while the combine's blocks start, so
// a read-only (non-coherent, hoistable) load of them would be wrong.
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// The row's live bound: slots j < live are attended from the cache.
template <bool FOLD>
__device__ __forceinline__ int live_of(const int32_t* offs, int off_scalar, int b, int S,
                                       int* off_out) {
  int off = offs != nullptr ? offs[b] : off_scalar;
  off = min(max(off, 0), S - 1);
  *off_out = off;
  return FOLD ? off : off + 1;
}

// lc[g] = (q of head g, scaled to log2 units) . k_new, for the G heads of the
// kv head; one warp, q and k_new in registers as each lane's groups of 4 dims.
template <int G, int NG>
__device__ __forceinline__ void fold_logits(const float (&qr)[G][NG][4], const float (&kn)[NG][4],
                                            float* lc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float s = dot4(qr[g][0], kn[0]);
#pragma unroll
    for (int v = 1; v < NG; ++v) s += dot4(qr[g][v], kn[v]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) lc[g] = s;
  }
}

template <int D, int G, bool FOLD, bool PAGED, typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<D>)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, D)
                    const T* k, const T* v,   // (B, S, Hkv, D) or pools
                    int S, const int32_t* __restrict__ offs, int off_scalar,
                    __nv_bfloat16* __restrict__ out,       // (B, H, D)
                    float* __restrict__ part,  // chunk partials, null for one chunk
                    int Hkv, float qscale, int chunk, const Fold<T> f, const Pages pg) {
  using KV = gptq_kv::Kv<T>;
  using L = Dims<D, T>;
  constexpr int kStages = L::kStages, kSliceElems = L::kSliceElems, NG = L::kGroups;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);   // [warp][stage][K | V][slot][D]
  __shared__ __align__(16) float pw[kWarps][G][kWarpSlots];   // each warp's probabilities
  __shared__ float wm[kWarps][G], wl[kWarps][G], lc[G];

  launch_dependents();
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const int H = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int off;
  const int live = live_of<FOLD>(offs, off_scalar, b, S, &off);
  const int t_begin = z * chunk;
  const int t_end = z == nsplit - 1 ? live : min(live, t_begin + chunk);

  if constexpr (FOLD) {
    // the row write: slot `off` is outside every chunk of this launch
    if (f.write && z == 0 && (f.write_mask == nullptr || f.write_mask[b] != 0)) {
      for (int d = tid; d < D; d += kThreads) {
        const size_t src = ((size_t)b * Hkv + kvh) * D + d;
        const size_t dst = (((size_t)b * S + off) * Hkv + kvh) * D + d;
        f.k_out[dst] = KV::encode(f.k_new[src]);
        f.v_out[dst] = KV::encode(f.v_new[src]);
      }
    }
  }
  // a chunk past the row's bound has no work; the combine does not read it.
  // One chunk (the fold form at offset 0) still writes v_new as the output.
  if (t_begin >= t_end && part != nullptr) return;

  const size_t row_stride = (size_t)Hkv * D;   // elements between cache slots
  const size_t base = (PAGED ? 0 : (size_t)b * S * row_stride) + (size_t)kvh * D;
  const T* kbase = k + base;
  const T* vbase = v + base;
  const int nt = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile : 0;

  // paged: lane l holds the table entry of this warp's slice of tile e0 + l
  // (0 for a slice wholly at or past t_end, whose entry is not read)
  int e0 = 0, entry = 0;
  auto load_entries = [&](int first) {
    const int slot = t_begin + (first + lane) * kTile + warp * kWarpSlots;
    entry = slot < t_end ? pg.tables[(size_t)b * pg.MB + slot / pg.BS] : 0;
  };
  if constexpr (PAGED) load_entries(0);

  // this warp's K slice of stage st (V follows it)
  auto slice = [&](int st) { return ring + (warp * kStages + st) * 2 * kSliceElems; };
  // tile t of the chunk into stage t % kStages: this warp's 8 slots, K and V,
  // in 16-byte copies of kE elements; slots at or past t_end are zero-filled
  // without a read
  constexpr int kE = L::kE, kRowCopies = L::kRowCopies, kCopies = L::kCopies;
  auto issue = [&](int t) {
    T* kd = slice(t % kStages);
    T* vd = kd + kSliceElems;
    const int slot0 = t_begin + t * kTile + warp * kWarpSlots;
    size_t first = 0;   // paged: the slice's first slot in the pool, in elements
    if constexpr (PAGED) {
      if (t >= e0 + 32) {   // warp-uniform
        e0 += 32;
        load_entries(e0);
      }
      const int phys = __shfl_sync(0xffffffffu, entry, t - e0);
      first = ((size_t)phys * pg.BS + slot0 % pg.BS) * row_stride;
    }
#pragma unroll
    for (int r = 0; r < (kCopies + 31) / 32; ++r) {
      const int i = lane + 32 * r, row = i / kRowCopies, c8 = (i % kRowCopies) * kE;
      if (kCopies % 32 != 0 && i >= kCopies) break;
      const bool ok = slot0 + row < t_end;
      size_t src;
      if constexpr (PAGED) {
        src = (ok ? first + row * row_stride : 0) + c8;
      } else {
        src = (size_t)(ok ? slot0 + row : 0) * row_stride + c8;
      }
      cp_async16(kd + row * D + c8, kbase + src, ok);
      cp_async16(vd + row * D + c8, vbase + src, ok);
    }
  };

  float m[G], l[G], acc[G][NG][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int u = 0; u < NG; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][u][i] = 0.0f;
  }
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  const int my_slot = lane >> 2;   // the slot whose full logit this lane ends up with

  // the whole ring in flight before the first tile is computed
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < nt) issue(t);
    cp_async_commit();
  }
  // this kv head's G query heads are contiguous in (B, H, D)
  float qr[G][NG][4];
  load_q<D, G>(q, (size_t)b * H + (size_t)kvh * G, qscale, lane, qr);
  // one chunk of the fold form: the current token's k (this lane's groups)
  // and v (this thread's output dims), loaded with q, not after the loop
  float kn[NG][4], vn[L::kPasses];
#pragma unroll
  for (int u = 0; u < NG; ++u) kn[u][0] = kn[u][1] = kn[u][2] = kn[u][3] = 0.0f;
#pragma unroll
  for (int p = 0; p < L::kPasses; ++p) vn[p] = 0.0f;
  if constexpr (FOLD) {
    if (part == nullptr) {
      const size_t row = ((size_t)b * Hkv + kvh) * D;
#pragma unroll
      for (int u = 0; u < NG; ++u)
        if (group_live<D>(u, lane)) fold_load4<T>(f.k_new + row + 128 * u + 4 * lane, kn[u]);
#pragma unroll
      for (int p = 0; p < L::kPasses; ++p)
        if (tid + kThreads * p < D) vn[p] = fold_value<T>(f.v_new[row + tid + kThreads * p]);
    }
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 1>();
    __syncwarp();   // every lane's copies of tile t landed
    const int slot0 = t_begin + t * kTile + warp * kWarpSlots;
    if (slot0 < t_end) {   // warp-uniform: the slice holds a live slot
      const T* kd = slice(t % kStages);
      const T* vd = kd + kSliceElems;

      // partial logits of the 8 slots over this lane's dims
      float s[kWarpSlots][G];
#pragma unroll
      for (int j = 0; j < kWarpSlots; ++j) {
        float kf[NG][4];
#pragma unroll
        for (int u = 0; u < NG; ++u) {
          if (group_live<D>(u, lane)) {
            KV::load4(kd + j * D + 128 * u + 4 * lane, kf[u]);
          } else {
            kf[u][0] = kf[u][1] = kf[u][2] = kf[u][3] = 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[j][g] = dot4(qr[g][0], kf[0]);
#pragma unroll
          for (int u = 1; u < NG; ++u) s[j][g] += dot4(qr[g][u], kf[u]);
        }
      }
      // transposing butterfly: lane l ends with the full logit of slot l >> 2
      float x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a4[4], a2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float send = hi16 ? s[i][g] : s[i + 4][g];
          a4[i] = (hi16 ? s[i + 4][g] : s[i][g]) + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float send = hi8 ? a4[i] : a4[i + 2];
          a2[i] = (hi8 ? a4[i + 2] : a4[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        const float send = hi4 ? a2[0] : a2[1];
        float a1 = (hi4 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
        a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
        a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
        x[g] = slot0 + my_slot < t_end ? a1 : -INFINITY;
      }
      // online softmax over the warp's slots; slot 0 of the slice is live, so
      // the new max is finite
      float alpha[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = x[g];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[g], mx);
        alpha[g] = ex2(m[g] - m_new);
        m[g] = m_new;
        if ((lane & 3) == 0) pw[warp][g][my_slot] = ex2(x[g] - m_new);
      }
      __syncwarp();
      float p[G][kWarpSlots];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p0 = *reinterpret_cast<const float4*>(&pw[warp][g][0]);
        const float4 p1 = *reinterpret_cast<const float4*>(&pw[warp][g][4]);
        p[g][0] = p0.x; p[g][1] = p0.y; p[g][2] = p0.z; p[g][3] = p0.w;
        p[g][4] = p1.x; p[g][5] = p1.y; p[g][6] = p1.z; p[g][7] = p1.w;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kWarpSlots; ++j) sum += p[g][j];
        l[g] = l[g] * alpha[g] + sum;
#pragma unroll
        for (int u = 0; u < NG; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][u][i] *= alpha[g];
      }
      // P V: dead slots' V rows are zeros and their p is 0
#pragma unroll
      for (int j = 0; j < kWarpSlots; ++j) {
#pragma unroll
        for (int u = 0; u < NG; ++u) {
          if (!group_live<D>(u, lane)) continue;
          float vf[4];
          KV::load4(vd + j * D + 128 * u + 4 * lane, vf);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[g][u][i] += p[g][j] * vf[i];
        }
      }
    }
    __syncwarp();   // every lane is done with tile t's stage and probabilities
    if (t + kStages < nt) issue(t + kStages);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncwarp();

  // merge the four warps: each writes its state into its own ring region
  // (G * D floats, 4 KB for G = 8 at D = 128, fit its kStages K and V
  // slices: 8 KB in fp8)
  constexpr int kWarpRegionBytes = kStages * 2 * kSliceElems * (int)sizeof(T);
  static_assert(G * D * 4 <= kWarpRegionBytes, "a warp's merge state must fit its ring region");
  float* wacc = reinterpret_cast<float*>(ring_raw + warp * kWarpRegionBytes);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < NG; ++u)
      if (group_live<D>(u, lane))
        *reinterpret_cast<float4*>(wacc + g * D + 128 * u + 4 * lane) =
            make_float4(acc[g][u][0], acc[g][u][1], acc[g][u][2], acc[g][u][3]);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
  }
  if constexpr (FOLD) {
    if (part == nullptr && warp == 0) fold_logits<G, NG>(qr, kn, lc);
  }
  __syncthreads();

  const size_t rows = (size_t)gridDim.y * Hkv * nsplit * G;
  const size_t row0 = (((size_t)b * Hkv + kvh) * nsplit + z) * G;
#pragma unroll
  for (int pass = 0; pass < L::kPasses; ++pass) {
    const int d = tid + kThreads * pass;   // one output dim per thread a pass
    if (d >= D) break;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w][g]);
      float L_ = 0.0f, O = 0.0f;
      if (M != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float e = ex2(wm[w][g] - M);   // 0 for a warp with no live slot
          L_ += e * wl[w][g];
          O += e * reinterpret_cast<const float*>(ring_raw + w * kWarpRegionBytes)[g * D + d];
        }
      }
      if (part != nullptr) {
        part[(row0 + g) * D + d] = O;
        if (d == 0) {
          part[rows * D + row0 + g] = M;
          part[rows * D + rows + row0 + g] = L_;
        }
        continue;
      }
      float o;
      if constexpr (FOLD) {   // the current token as the last slot
        const float m_new = fmaxf(M, lc[g]);
        const float corr = ex2(M - m_new), pn = ex2(lc[g] - m_new);
        o = (O * corr + pn * vn[pass]) / (L_ * corr + pn);
      } else {
        o = O / L_;
      }
      out[((size_t)b * H + (size_t)kvh * G + g) * D + d] = __float2bfloat16_rn(o);
    }
  }
}

// Rescales each chunk of a (row, kv head) to the common max and sums the
// chunks in chunk order; only the chunks that start below the row's live
// bound wrote partials. The fold form adds the current token as one more
// slot. The chunks' maxima and denominators are staged in shared memory, one
// warp per query head turns them into weights, and every thread then sums
// its output dims (one a pass of 128) with 8 chunks' loads in flight at a
// time.
template <int D, int G, bool FOLD, typename T>
__global__ void __launch_bounds__(kThreads)
dense_combine_kernel(const float* part, __nv_bfloat16* __restrict__ out,
                     int Hkv, int nsplit, int chunk, int S, const int32_t* __restrict__ offs,
                     int off_scalar, const __nv_bfloat16* __restrict__ q, float qscale,
                     const Fold<T> f) {
  using L = Dims<D, T>;
  constexpr int NG = L::kGroups;
  __shared__ float sm[kMaxSplit * G], sl[kMaxSplit * G], sM[G], sL[G], lc[G];
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t rows = (size_t)gridDim.y * Hkv * nsplit * G;
  const size_t base = ((size_t)b * Hkv + kvh) * nsplit * G;   // row of chunk 0, head 0
  const float* pm = part + rows * D + base;
  const float* pl = part + rows * D + rows + base;
  int off;
  const int live = live_of<FOLD>(offs, off_scalar, b, S, &off);
  const int nz = live > 0 ? min(nsplit, (live + chunk - 1) / chunk) : 0;
  float vn[L::kPasses];
#pragma unroll
  for (int p = 0; p < L::kPasses; ++p) vn[p] = 0.0f;
  if constexpr (FOLD) {   // the current token: inputs of this launch, not partials
    const size_t row = ((size_t)b * Hkv + kvh) * D;
#pragma unroll
    for (int p = 0; p < L::kPasses; ++p)
      if (tid + kThreads * p < D) vn[p] = fold_value<T>(f.v_new[row + tid + kThreads * p]);
    if (warp == 0) {
      float qr[G][NG][4], kn[NG][4];
      load_q<D, G>(q, (size_t)b * Hkv * G + (size_t)kvh * G, qscale, lane, qr);
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        kn[u][0] = kn[u][1] = kn[u][2] = kn[u][3] = 0.0f;
        if (group_live<D>(u, lane)) fold_load4<T>(f.k_new + row + 128 * u + 4 * lane, kn[u]);
      }
      fold_logits<G, NG>(qr, kn, lc);
    }
  }
  grid_dependency_wait();   // every chunk's block has finished and its partials are visible
  // one load round: the maxima and denominators, and this thread's first dim
  // of the first kBatch chunks' accumulators
  constexpr int kBatch = 64 / G;
  float x[kBatch][G];
  auto load_batch = [&](int c0, int d) {
    const float* pa = part + base * D + d;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int g = 0; g < G; ++g)
        x[j][g] = c0 + j < nz ? ld_cg(pa + ((size_t)(c0 + j) * G + g) * D) : 0.0f;
  };
  if (tid < D) load_batch(0, tid);
  for (int i = tid; i < nz * G; i += kThreads) {   // i = chunk * G + head
    sm[i] = ld_cg(pm + i);
    sl[i] = ld_cg(pl + i);
  }
  __syncthreads();
  // weights: warp g takes head g; lane c, c + 32, ... its chunks
  for (int g = warp; g < G; g += kWarps) {
    float mx = FOLD ? lc[g] : -INFINITY;
    for (int c = lane; c < nz; c += 32) mx = fmaxf(mx, sm[c * G + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.0f;
    for (int c = lane; c < nz; c += 32) {
      const float w = ex2(sm[c * G + g] - mx);
      sm[c * G + g] = w;
      den += w * sl[c * G + g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) {
      sM[g] = mx;
      sL[g] = den + (FOLD ? ex2(lc[g] - mx) : 0.0f);
    }
  }
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < L::kPasses; ++pass) {
    const int d = tid + kThreads * pass;
    if (d >= D) break;
    float num[G];
#pragma unroll
    for (int g = 0; g < G; ++g) num[g] = FOLD ? ex2(lc[g] - sM[g]) * vn[pass] : 0.0f;
    for (int c0 = 0; c0 < nz; c0 += kBatch) {
      if (c0 > 0 || pass > 0) load_batch(c0, d);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (c0 + j < nz) num[g] += sm[(c0 + j) * G + g] * x[j][g];
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      out[((size_t)b * Hkv * G + (size_t)kvh * G + g) * D + d] = __float2bfloat16_rn(num[g] / sL[g]);
  }
}

template <int D, int G, bool FOLD, bool PAGED, typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v, int S, const void* offs,
                     int off_scalar, void* out, void* part, int B, int Hkv, float scale,
                     int nsplit, int chunk, const Fold<T>& f, const Pages& pg,
                     cudaStream_t stream) {
  constexpr int kSmemBytes = Dims<D, T>::kSmemBytes;
  static unsigned configured = 0;   // per device: the ring may be above the 48 KB default
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(dense_decode_kernel<D, G, FOLD, PAGED, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    configured |= 1u << dev;
  }
  const float qscale = scale * kLog2e;
  float* p = nsplit > 1 ? static_cast<float*>(part) : nullptr;
  dense_decode_kernel<D, G, FOLD, PAGED, T><<<dim3(Hkv, B, nsplit), kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), S, static_cast<const int32_t*>(offs), off_scalar,
      static_cast<__nv_bfloat16*>(out), p, Hkv, qscale, chunk, f, pg);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  // programmatic dependent launch: the combine's blocks start while the
  // chunks' last blocks run and wait (griddepcontrol.wait) for their partials
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dense_combine_kernel<D, G, FOLD, T>,
                            static_cast<const float*>(p), static_cast<__nv_bfloat16*>(out), Hkv,
                            nsplit, chunk, S, static_cast<const int32_t*>(offs), off_scalar,
                            static_cast<const __nv_bfloat16*>(q), qscale, f);
}

// Chunk c of a row covers slots [c * chunk, (c + 1) * chunk), the last one up
// to the row's live bound; chunk is a multiple of the 32-slot tile and nsplit
// at most kMaxSplit. nsplit > 1
// needs `part`: B * Hkv * nsplit * G * (D + 2) floats. FOLD needs f.k_new and
// f.v_new (and, with f.write, f.k_out and f.v_out). PAGED: k and v are the
// pools, S the logical length MB * BS, pg the tables (BS % 8 == 0). T: the
// cache element type. D must be the library's head dim (kHeadDim).
template <typename T, bool FOLD, bool PAGED = false>
cudaError_t launch(const void* q, const void* k, const void* v, int S, const void* offs,
                   int off_scalar, void* out, void* part, int B, int Hkv, int G, int D,
                   float scale, int nsplit, int chunk, cudaStream_t st,
                   const Fold<T>& f = Fold<T>{}, const Pages& pg = Pages{}) {
  if (D != kHeadDim || B < 1 || S < 1 || Hkv < 1 || nsplit < 1 || nsplit > kMaxSplit ||
      chunk < kTile || chunk % kTile != 0 ||
      (nsplit > 1 && part == nullptr) ||
      (FOLD && (f.k_new == nullptr || f.v_new == nullptr ||
                (f.write && (f.k_out == nullptr || f.v_out == nullptr)))) ||
      (PAGED && (FOLD || pg.tables == nullptr || pg.BS < kWarpSlots ||
                 pg.BS % kWarpSlots != 0 || pg.MB < 1 || S != pg.MB * pg.BS)))
    return cudaErrorInvalidValue;
#define GPTQ_G(N)                                                                          \
  launch_g<kHeadDim, N, FOLD, PAGED, T>(q, k, v, S, offs, off_scalar, out, part, B, Hkv,     \
                                        scale, nsplit, chunk, f, pg, st)
  switch (G) {
    case 1: return GPTQ_G(1);
    case 2: return GPTQ_G(2);
    case 3: return GPTQ_G(3);
    case 4: return GPTQ_G(4);
    case 5: return GPTQ_G(5);
    case 6: return GPTQ_G(6);
    case 7: return GPTQ_G(7);
    case 8: return GPTQ_G(8);
    default: return cudaErrorInvalidValue;
  }
#undef GPTQ_G
}

}  // inline namespace of the head dim
}  // namespace gptq_dense

// The layout the host plan (ops/cuda/attention.py) assumes, read once when a
// library that includes this header is loaded: head dim, slots per tile,
// resident blocks per SM (at most), chunks the combine stages, and the
// ring's bytes over an fp8, a bf16 and an f32 cache.
extern "C" void gptq_dense_decode_layout(int* out) {
  using namespace gptq_dense;
  const int v[] = {kHeadDim, kTile, kBlocksPerSm<kHeadDim>, kMaxSplit,
                   Dims<kHeadDim, gptq_kv::e4m3>::kSmemBytes,
                   Dims<kHeadDim, __nv_bfloat16>::kSmemBytes, Dims<kHeadDim, float>::kSmemBytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
