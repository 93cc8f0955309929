// Causal prefill attention on bf16 tensor cores, shared by kernel 5
// (flash_prefill.cu: no cache, SQ == SKV, offset 0) and kernel 4
// (flash_prefill_blocked.cu: a chunk of SQ queries at a cache offset).
//
// q (B, SQ, H, D), k/v (B, SKV, Hkv, D), bf16. Query row i sits at
// absolute position q_offset + i and attends cache slots j <= q_offset + i,
// j < SKV; query head h reads kv head h / (H / Hkv). Logits are fp32 (bf16
// q and k, fp32 accumulation) times scale, the softmax is fp32, and p is
// rounded to bf16 before p @ v, which accumulates in fp32: the TPU kernels'
// operand types (gptq_for_llama_tpu/ops/pallas/flash.py:103-118). The TPU
// kernels normalize p before the cast; here the online softmax divides the
// fp32 accumulator at the end. The wgmma body takes exp(x * scale - m) as
// 2^(x * scale * log2(e) - m'), one FFMA and one ex2.
//
// What bounds it on the H100: operations, once a chunk holds a few hundred
// queries (B = 8, S = 2048, H = 32 is 275 GFLOP of causal work per layer
// against 134 MB, 0.28 ms at 989 TFLOP/s); for a short chunk over a short
// live prefix, bytes. Two bodies, both hand-written; the wrapper's plan
// (ops/cuda/flash_prefill.py:plan) picks one from offset + SQ and D, the
// same way for both kernels, so kernel 4 at offset 0 stays bit-equal to
// kernel 5:
//
// flash_wgmma_kernel (the TPU kernels keep a head's whole K/V in VMEM; an SM
// has no such room: 512 KB at S = 2048):
//  - one block per (head, 128-query tile, batch row): two consumer
//    warpgroups of 64 query rows each and a producer warpgroup whose first
//    warp issues every copy; setmaxnreg moves registers from the producer to
//    the consumers (a lone producer warp frees too few: the consumers' request
//    waits for ever); blocks launch by group of heads (the fewest whose tiles
//    fill the SMs; one head past 16 waves), heaviest (last) query tile first
//    within a group: with the tile the fastest index at a few waves, the
//    heavy tiles of the last heads started a wave late, and with every head
//    in one group, the K/V of all heads did not stay in L2;
//  - the producer keeps TMA loads of 128-key K and V tiles (80-key at D =
//    256) in flight through 3-stage rings (2 at D = 256) of mbarriers (full:
//    bytes landed; empty: both consumer warpgroups done; K and V each their
//    own), Q is loaded once; tensor maps are encoded on the host (4-D, so
//    rows past SQ or SKV of a batch row read as zeros), a tile in sub-tiles
//    of 64, 32 or 16 dims (WgmmaDims) whose rows take the 128-, 64- or
//    32-byte swizzle the wgmma descriptors expect;
//  - S = Q K^T by wgmma.m64n128k16 (m64n80k16 at D = 256) from shared
//    memory (D / 16 k-steps); the softmax runs on the accumulators in fp32
//    (running max and denominator per row); P goes from the accumulators
//    straight to bf16 A fragments in registers, and O += P V by
//    wgmma.m64nDk16 with V read from shared memory through the transpose
//    bit; named barriers hand the tensor cores from one warpgroup to the
//    other, so one's softmax runs while the other's products do, and each
//    warpgroup issues P(t-1) V(t-1) with S(t), so its own softmax of tile t
//    overlaps its previous tile's P V;
//  - key tiles wholly above the tile's causal limit (q_offset + its last row,
//    kv_end) are never loaded; slots past kv_end are masked, and where a
//    cache tile reaches past kv_end its V rows there are zeroed in shared
//    memory before P V (a cache may hold NaN there, and 0 * NaN is NaN).
//
// flash_sync_kernel (a short causal prefix: at most
// ops/cuda/flash_prefill.py:SYNC_MAX_KEYS[D] keys, the crossover measured
// for each D):
//  - one block of 4 warps per (64-query tile, head, batch row); each warp
//    owns 16 query rows; heaviest tiles first;
//  - K/V stream through shared memory in 64-key tiles with cp.async: V(t) is
//    fetched while S = Q K(t)^T is computed, K(t+1) while P V(t) is;
//  - both products are mma.sync.m16n8k16 bf16 with fp32 accumulators; Q's
//    fragments stay in registers; P goes from the S accumulators straight to
//    A fragments (the m16n8 C layout is the m16k16 A layout);
//  - rows past SQ and slots past the causal limit are zero-filled.
// Both take any SQ, SKV and offset (the TPU kernels need SQ % 128 == 0 with
// an offset, S % 256 == 0 without). OFFSET = false compiles the offset out
// (kernel 5: SQ == SKV, offset 0). With OFFSET the block reads the offset
// from device memory, as the TPU kernel takes its q_offset by scalar
// prefetch, and optionally the cache row of its batch row: the grid depends
// on SQ alone, so one captured launch serves every offset and slot.
// Kernel 4's cache may be stored in f32, fp8-e4m3 or fp8-e5m2 as well as bf16
// (kv_dtype.cuh), under the same plan as bf16. Its tiles are rounded to bf16
// as the TPU kernel's _load_bf16 does (exact for fp8, nearest even from f32;
// kv_dtype.cuh: bf16x8) on their way into the bodies' bf16 tile layouts. In
// the mma.sync body the K and V tiles are loaded in the stored type into
// registers where the bf16 body issues its cp.async (V(t) before S(t) is
// computed, K(t+1) before P V(t)). In the wgmma body (D = 64, 80, 96, 128)
// the producer warpgroup's first thread keeps TMA loads of the stored chunks
// in flight through a staging ring, and its 128 threads convert each chunk
// into the swizzled bf16 stage the descriptors read; the consumers run
// unchanged, so the output equals the bf16 body's over the cache decoded to
// bf16, bit for bit. The ring takes shared memory: at D = 128 the bf16 rings
// keep 2 stages and 4 staging slots of 16 KB take the third's room; at D =
// 256 there is none, and such a cache takes the mma.sync body only.
//
// The head dim: one library per D (64, 80, 96, 128, 256), built with
// -DGPTQ_HEAD_DIM. The mma.sync body is a template on D (any multiple of 16:
// the m16n8k16 products and the 16-byte copies divide every row); at D = 256
// Q's fragments are read from shared memory for each product, not kept in
// registers, and a tile of another type than bf16 is converted as it is
// loaded, so the 16 x 256 fp32 accumulator fits a thread's registers. The
// wgmma body is a template on D too and takes D = 64, 80, 96, 128 and 256: a
// row of 2 D bytes is cut into sub-tiles of the widest swizzle that divides
// it (64 dims at 256, 128 and 64, 32 at 96, 16 at 80), one TMA box and one
// descriptor mode each, and P V is one m64nDk16 product. At D = 256 its O
// accumulator takes 128 fp32 a thread and Q a 64 KB tile, so the K and V
// tiles hold 80 keys (kWKeys256), S is an m64n80k16 product of 40 fp32 a
// thread, P V five m64n256k16 products a tile, and the rings hold 2 stages
// (230,528 bytes of shared memory); a causal edge then falls inside a key
// tile, which the mask handles as it does a ragged one.
// Up to D = 128 both bodies' arithmetic is the same, in the same order, as
// with D fixed at 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "kv_dtype.cuh"
#include "mma_sync.cuh"

#ifndef GPTQ_HEAD_DIM
#define GPTQ_HEAD_DIM 128
#endif
#define GPTQ_HD_NS2(d) hd##d
#define GPTQ_HD_NS(d) GPTQ_HD_NS2(d)

// Every name of this header is in an inline namespace of the head dim, so
// the libraries of two head dims loaded in one process share no symbol: a
// function-local static of a template (a GNU unique symbol) would otherwise
// be one object for all of them, and a kernel's attribute set in one
// library would count as set in the other.
namespace gptq_flash {
inline namespace GPTQ_HD_NS(GPTQ_HEAD_DIM) {

using namespace gptq_mma;

constexpr int kHeadDim = GPTQ_HEAD_DIM;   // the head dim this library is built for
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;           // running-max start: finite, so exp never sees inf - inf

// The mma.sync body's layout at head dim D (a multiple of 16)
template <int D>
struct SyncDims {
  static_assert(D % 16 == 0 && D >= 64 && D <= 256, "head dim: a multiple of 16 in 64..256");
  static constexpr int kStride = D + 8;        // bf16 per smem row: conflict-free ldmatrix
  static constexpr int kTile = kBQ * kStride;  // elements of one 64 x D tile
  static constexpr int kSmemBytes = 3 * kTile * 2;   // Q, K, V: 52,224 B at D = 128
  static constexpr int kRowChunks = D / 8;     // 8-element chunks a row
  static constexpr int kChunks = kBQ * kRowChunks / kThreads;   // chunks a thread copies
  // up to D = 128 Q's fragments stay in registers and a tile of another type
  // than bf16 is staged in registers across the compute; above, Q is read
  // from shared memory for each product and such a tile is converted as it
  // is loaded (the registers go to the 16 x D accumulator)
  static constexpr bool kKeep = D <= 128;
};

// rows [row0, row0 + 64) of a (.., S, heads, D) tensor into a padded bf16
// smem tile in two steps; rows >= S are zero-filled. ``fetch`` starts the
// copy: for bf16, cp.async into ``dst`` (``put`` then does nothing); for a
// cache of another type T, plain loads of the thread's chunks of 8
// elements into ``Staged<T>`` registers, which ``put`` reads as the decode
// kernels do (gptq_kv::Kv<T>::load4), rounds to bf16 and stores. The loads are in flight while the
// caller computes between the two.
template <typename T, int D, bool STAGE = !std::is_same<T, __nv_bfloat16>::value && SyncDims<D>::kKeep>
struct Staged {
  alignas(16) T x[SyncDims<D>::kChunks][8];
};
template <typename T, int D>
struct Staged<T, D, false> {};

// 8 elements of type T from registers, rounded to nearest even bf16 (exact
// for fp8; zeros stay zeros), into dst
template <typename T>
__device__ __forceinline__ void put8(__nv_bfloat16* dst, const T* x) {
  *reinterpret_cast<uint4*>(dst) = gptq_kv::bf16x8(x);
}

// 8 elements of type T (one or two 16-byte loads) into x; zeros when !ok
template <typename T>
__device__ __forceinline__ void load8(T* x, const T* src, bool ok) {
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint2*>(x) = ok ? *reinterpret_cast<const uint2*>(src) : make_uint2(0u, 0u);
  } else {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(x) = ok ? *reinterpret_cast<const float4*>(src) : z;
    *reinterpret_cast<float4*>(x + 4) = ok ? *reinterpret_cast<const float4*>(src + 4) : z;
  }
}

template <int D, typename T>
__device__ __forceinline__ void fetch(__nv_bfloat16* dst, Staged<T, D>& st, const T* base,
                                      size_t row_stride, int row0, int S, int tid) {
  using FD = SyncDims<D>;
#pragma unroll
  for (int i = 0; i < FD::kChunks; ++i) {
    const int c = tid + i * kThreads, r = c / FD::kRowChunks, c8 = (c % FD::kRowChunks) * 8;
    const bool ok = row0 + r < S;
    const T* src = base + (size_t)(ok ? row0 + r : 0) * row_stride + c8;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      cp_async16(dst + r * FD::kStride + c8, src, ok);
    } else if constexpr (FD::kKeep) {
      load8(st.x[i], src, ok);
    } else {
      alignas(16) T x[8];
      load8(x, src, ok);
      put8(dst + r * FD::kStride + c8, x);
    }
  }
}

template <int D, typename T>
__device__ __forceinline__ void put(__nv_bfloat16* dst, const Staged<T, D>& st, int tid) {
  using FD = SyncDims<D>;
  if constexpr (!std::is_same<T, __nv_bfloat16>::value && FD::kKeep) {
#pragma unroll
    for (int i = 0; i < FD::kChunks; ++i) {
      const int c = tid + i * kThreads, r = c / FD::kRowChunks, c8 = (c % FD::kRowChunks) * 8;
      put8(dst + r * FD::kStride + c8, st.x[i]);
    }
  }
}

// a bf16 tile, cp.async only (q, and kernel 5's k/v)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          size_t row_stride, int row0, int S, int tid) {
  Staged<__nv_bfloat16, D> none;
  fetch<D>(dst, none, base, row_stride, row0, S, tid);
}

// The chunk's first absolute position, read from device memory (kernel 4: a
// CUDA graph replays one launch at whatever offset the buffer holds), and the
// cache row batch row b attends (the identity without ``rows``; a row out of
// range is clamped, so a bad index reads a wrong row, never outside the cache).
template <bool OFFSET>
__device__ __forceinline__ int chunk_offset(const int* q_offset) {
  return OFFSET ? __ldg(q_offset) : 0;
}
template <bool OFFSET>
__device__ __forceinline__ int cache_row(const int* rows, int b, int Bkv) {
  return (OFFSET && rows != nullptr) ? min(max(__ldg(rows + b), 0), Bkv - 1) : b;
}

// grid: (ceil(SQ / kBQ), H, B); block: kThreads; dynamic smem:
// SyncDims<D>::kSmemBytes. T: the cache element type (bf16 for kernel 5).
template <int D, bool OFFSET, typename T>
__global__ void __launch_bounds__(kThreads)
flash_sync_kernel(const __nv_bfloat16* __restrict__ q,   // (B, SQ, H, D)
             const T* __restrict__ k,               // (B, SKV, Hkv, D)
             const T* __restrict__ v,               // (B, SKV, Hkv, D)
             __nv_bfloat16* __restrict__ out,       // (B, SQ, H, D)
             int SQ, int Bkv, int SKV, int H, int Hkv,
             const int* __restrict__ q_offset,      // (1,): the chunk's first position
             const int* __restrict__ rows,          // (B,) cache row per batch row, or null
             float scale) {
  using FD = SyncDims<D>;
  constexpr int kStride = FD::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + FD::kTile;
  __nv_bfloat16* vs = ks + FD::kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int off = chunk_offset<OFFSET>(q_offset);
  const int kb = cache_row<OFFSET>(rows, b, Bkv);
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* qbase = q + ((size_t)b * SQ * H + h) * D;
  const T* kbase = k + ((size_t)kb * SKV * Hkv + kvh) * D;
  const T* vbase = v + ((size_t)kb * SKV * Hkv + kvh) * D;

  // keys up to the causal limit of the tile's last real row; slots past it
  // are never read (zero-filled), so a cache may hold anything there
  const int kv_end = min(SKV, off + min(q0 + kBQ, SQ));
  const int n_kt = (kv_end - 1) / kBK + 1;
  Staged<T, D> st;   // a K or V tile of another type than bf16, on its way in
  load_tile<D>(qs, qbase, q_stride, q0, SQ, tid);
  fetch<D>(ks, st, kbase, kv_stride, 0, kv_end, tid);
  put<D>(ks, st, tid);
  cp_async_commit();
  const int row_lo = q0 + warp * 16 + g;               // this thread's two rows
  const int row_hi = row_lo + 8;
  const int pos_lo = off + row_lo, pos_hi = off + row_hi;   // their absolute positions

  uint32_t qf[FD::kKeep ? D / 16 : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.0f, l_hi = 0.0f;   // l: this thread's partial sums
  // the A fragment of Q's dims 16 kk .. 16 kk + 15 for this warp's rows
  auto q_frag = [&](uint32_t (&a)[4], int kk) {
    ldsm_x4(a, qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + kk * 16 +
                   (lane >> 4) * 8);
  };

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();   // K(kt) (and Q) landed; every warp is done with V(kt-1)
    fetch<D>(vs, st, vbase, kv_stride, k0, kv_end, tid);
    cp_async_commit();
    if constexpr (FD::kKeep) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) q_frag(qf[kk], kk);
      }
    }

    // s = q k^T: 16 rows x 64 keys per warp
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (FD::kKeep) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        q_frag(a, kk);
      }
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], a, bf[0], bf[1]);
        mma16816(s[2 * np + 1], a, bf[2], bf[3]);
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
    for (int n = 0; n < D / 8; ++n) {
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

    put<D>(vs, st, tid);   // V(kt), fetched before S was computed
    cp_async_wait_all();
    __syncthreads();   // V(kt) landed; every warp is done with K(kt)
    if (kt + 1 < n_kt) {
      fetch<D>(ks, st, kbase, kv_stride, k0 + kBK, kv_end, tid);
      cp_async_commit();
    }

    // o += p v: 16 rows x D dims per warp
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                              dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pf[j], bf[0], bf[1]);
        mma16816(o[2 * dp + 1], pf[j], bf[2], bf[3]);
      }
    }
    if (kt + 1 < n_kt) put<D>(ks, st, tid);   // K(kt + 1), fetched before P V
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
  }
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
  if (row_lo < SQ) {
    __nv_bfloat16* orow = out + ((size_t)b * SQ + row_lo) * q_stride + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
  }
  if (row_hi < SQ) {
    __nv_bfloat16* orow = out + ((size_t)b * SQ + row_hi) * q_stride + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
}


// -- flash_wgmma_kernel ------------------------------------------------------
// 2^x, the MUFU's approximation (what __expf computes after its multiply)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kWBQ = 128;                 // query rows per block: two warpgroups of 64
constexpr int kWThreads = 384;            // warps 0-7 consume, warps 8-11 produce
// K and V tiles in flight up to D = 128: rings as deep as shared memory
// allows (6 stages at D = 64, 5 at 80, 4 at 96) measured no faster
// (scripts/torch_flash_bodies.py); D = 256 has room for 2
constexpr int kWStages = 3;
// keys per K/V tile at D = 256 (128 below): a 64 KB Q tile and 2 stages of
// K and V fit a block with 80-key tiles (229,376 B of tiles); 64-key ones
// (196,608 B) measured 7 % slower at S = 2048, B = 1 and 8
// (scripts/torch_flash_bodies.py, variant keys64)
constexpr int kWKeys256 = 80;
// registers a thread: 168 at launch (65536 / 384); the producer warpgroup
// gives up 144 each, the consumers take 72 each (128 x 144 = 256 x 72)
constexpr int kWConsumerRegs = 240, kWProducerRegs = 24;
// over a cache of another type than bf16 the producer warpgroup converts
// tiles and keeps 40 (its loops, the staging addresses and one 8-element
// unit); the consumers take 232 (128 x 40 + 256 x 232 = 64,512)
constexpr int kWConvConsumerRegs = 232, kWConvProducerRegs = 40;
// named barriers: 1 orders the zeroing of V's rows past the causal limit;
// 2 + w is warpgroup w's turn to issue its products
constexpr int kBarZero = 1, kBarTurn = 2;
// bytes of one staging slot at most: a chunk of a K or V tile in its stored
// type (a whole 128-key tile of fp8 up to D = 128; 32-64 keys of f32)
constexpr int kWSlotBytes = 16384;
constexpr int kWMaxSlots = 4;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may have

// The head dims the wgmma body takes: each a whole number of 16-dim k-steps
// and an m64nDk16 product (at 256 the O accumulator is 128 fp32 a thread).
constexpr bool wgmma_dim(int d) {
  return d == 64 || d == 80 || d == 96 || d == 128 || d == 256;
}
// ... and over a cache of another type than bf16 (kernel 4): at D = 256 a 64
// KB Q tile and 2 bf16 stages of 80-key K and V tiles take 230,528 of the
// 232,448 bytes, which leaves no room for a staging ring
constexpr bool wgmma_kv_dim(int d) { return wgmma_dim(d) && d != 256; }

// the mbarriers of a block with `stages` K and V stages and up to `slots`
// staging slots, in bytes (128-byte steps)
constexpr int wgmma_bar_bytes(int stages, int slots) {
  return ((1 + 4 * stages + 2 * slots) * 8 + 127) / 128 * 128;
}
// the bytes a block has left for staging slots beside Q, the stages, the
// barriers and 1 KB of alignment
constexpr int wgmma_room(int tile_q, int tile_kv, int stages, int slots) {
  return kSmemLimit - 1024 - wgmma_bar_bytes(stages, slots) - tile_q - 2 * stages * tile_kv;
}
// keys of a staging chunk: the most (a tile's, halved) whose row_bytes-byte
// rows fit a slot
constexpr int chunk_keys(int keys, int row_bytes) {
  int c = keys;
  while (c * row_bytes > kWSlotBytes && c % 2 == 0 && c > 8) c /= 2;
  return c;
}

// The wgmma body's layout at head dim D. A tile (Q: 128 rows; a K or V tile:
// kKeys rows) is stored as D / kBoxDims sub-tiles, one TMA box each, of its
// rows x kBoxDims dims: rows of kRowBytes in the swizzle of that width (the
// widest of 128, 64, 32 bytes that divides a row of 2 D bytes, so the
// sub-tiles are alike and one descriptor mode reads them all: D = 256, 128
// and 64 in 64-dim sub-tiles with the 128-byte swizzle, 96 in 32-dim ones
// with the 64-byte swizzle, 80 in 16-dim ones with the 32-byte swizzle).
// S = Q K^T takes D / 16 k-steps, each inside one sub-tile; O += P V is one
// m64nDk16 product a 16-key step, its N spread over the sub-tiles (the
// descriptor's lbo). Up to D = 128 a K/V tile holds 128 keys and the rings 3
// stages; at 256 a 64 KB Q tile leaves room for 2 stages of kWKeys256-key
// tiles.
//
// T is the cache's stored type. Over bf16 the TMA loads land in the stages
// themselves. Over another type (up to D = 128) the producer warpgroup fills
// the bf16 stages: TMA loads of chunks of kChunkKeys keys in the stored type
// (no swizzle, rows of D elements) land in a ring of kSlots staging slots,
// the warpgroup's 128 threads convert each into the stage's swizzled rows.
// The staging ring takes the room of the third bf16 stage where there is no
// other (D = 128: 2 stages of K and V and 4 slots of 16 KB).
template <int D, typename T = __nv_bfloat16>
struct WgmmaDims {
  static_assert(wgmma_dim(D), "the wgmma body takes D = 64, 80, 96, 128 or 256");
  static constexpr bool kConv = !std::is_same<T, __nv_bfloat16>::value;   // the producer converts
  static_assert(!kConv || wgmma_kv_dim(D), "a cache of another type than bf16: D <= 128");
  static constexpr int kBoxDims = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kBoxes = D / kBoxDims;
  static constexpr int kRowBytes = 2 * kBoxDims;
  static constexpr int kKeys = D == 256 ? kWKeys256 : 128;   // keys per K/V tile
  static constexpr int kSubQ = kWBQ * kRowBytes;     // one sub-tile of Q
  static constexpr int kSubKV = kKeys * kRowBytes;   // one sub-tile of a K or V tile
  static constexpr int kTileQ = kBoxes * kSubQ;      // 128 rows x D dims, bf16
  static constexpr int kTileKV = kBoxes * kSubKV;    // kKeys rows x D dims, bf16
  static constexpr int kAtom = 8 * kRowBytes;        // 8 rows: the swizzle atom
  // the staging ring: chunks of kChunkKeys keys (kChunks a tile), a slot each
  static constexpr int kChunkKeys = chunk_keys(kKeys, D * (int)sizeof(T));
  static constexpr int kChunks = kKeys / kChunkKeys;
  static constexpr int kSlotBytes = kChunkKeys * D * (int)sizeof(T);
  static constexpr int kMaxSlots = kConv ? kWMaxSlots : 0;
  // Q, the K stages, the V stages, the staging slots, then 1 + 4 kStages + 2
  // kMaxSlots mbarriers (in 128 B steps); 1 KB to align the tiles. Over bf16:
  // 230,528 bytes of the 232,448 a block may have at D = 128 and at 256
  // (80-key tiles), 173,184 at 96, 144,512 at 80, 115,840 at 64.
  // K and V tiles in flight: 3 stages (2 at D = 256), 2 where 3 would leave
  // no room for two staging slots
  static constexpr int kStages =
      D == 256 ? 2
      : (!kConv || wgmma_room(kTileQ, kTileKV, kWStages, kMaxSlots) >= 2 * kSlotBytes)
          ? kWStages
          : kWStages - 1;
  static constexpr int kRoom = wgmma_room(kTileQ, kTileKV, kStages, kMaxSlots);
  static constexpr int kSlots =
      kConv ? (kRoom / kSlotBytes < kMaxSlots ? kRoom / kSlotBytes : kMaxSlots) : 0;
  static constexpr int kBarBytes = wgmma_bar_bytes(kStages, kMaxSlots);
  static constexpr int kSmemBytes =
      kTileQ + 2 * kStages * kTileKV + kSlots * kSlotBytes + kBarBytes + 1024;
  static_assert(kKeys == 64 || kKeys == 80 || kKeys == 128, "an S product hopper.cuh has");
  static_assert(!kConv || (kSlots >= 2 && kChunks * kChunkKeys == kKeys && kSlotBytes % 1024 == 0),
                "a staging ring of two whole slots or more");
  static_assert(kSmemBytes <= kSmemLimit, "the ring fits a block");
};

// grid: (G, ceil(SQ / kWBQ), B * H / G), G heads a group; block: kWThreads;
// dynamic smem:
// WgmmaDims<D, T>::kSmemBytes. tq / tk / tv: 4-D tensor maps (D, heads, rows, B)
// of q and (D, heads, rows, Bkv) of k, v with a box of one sub-tile
// (kBoxDims, 1, 128 or kKeys, 1) in the swizzle of its row width; over
// another type T than bf16, tk / tv have a box of one staging chunk (D, 1,
// kChunkKeys, 1) in T, unswizzled.
//
// The producer warpgroup over such a cache, per chunk of the K(t), V(t - 1)
// order: its first thread keeps the TMA loads of the next chunks in flight
// through the staging ring (each slot reloaded once all 128 threads have
// read it); every thread waits for the chunk, reads 8-element units of it,
// rounds them to bf16 (kv_dtype.cuh: bf16x8) and stores each as one 16-byte
// chunk of its row in the stage, at the place the TMA swizzle of that row
// width puts it (16-byte chunk c of row r of a sub-tile at c ^ ((r kRow /
// 128) mod (kRow / 16))); keys from kv_end on become zeros, so NaN past the
// causal limit never reaches the stage. After a tile's last chunk each thread
// fences its stores for the async proxy and arrives on the stage's full
// barrier (128 arrivals: no transaction count). The consumers run as over
// bf16: the stages hold the same bf16 values as a bf16 cache decoded from
// this one would give them, so the output is the same bit for bit.
//
// Each consumer warpgroup runs, per key tile t: wait for its turn; issue S(t)
// = Q K(t)^T and O += P(t-1) V(t-1); hand the turn to the other warpgroup;
// wait for S(t) and release K(t); the softmax of S(t); wait for P V and
// release V(t-1); rescale O; P(t) to bf16 A fragments. So one warpgroup's
// softmax runs while the other's products do, and within a warpgroup the
// softmax of tile t overlaps P(t-1) V(t-1). O sees the same operations in the
// same order as O = O a(t) + P(t) V(t) tile after tile.
template <int D, bool OFFSET, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                   int SQ, int Bkv, int SKV, int H, int Hkv, const int* __restrict__ q_offset,
                   const int* __restrict__ rows, float scale) {
  using namespace gptq_hopper;
  using WD = WgmmaDims<D, T>;
  constexpr int kTileQ = WD::kTileQ, kTileKV = WD::kTileKV;
  constexpr int kSubQ = WD::kSubQ, kSubKV = WD::kSubKV;
  constexpr int kRow = WD::kRowBytes, kAtom = WD::kAtom;
  constexpr int kKeys = WD::kKeys, kStages = WD::kStages;
  constexpr int kSlots = WD::kSlots;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t sq = base;                                  // Q: sub-tiles kSubQ apart
  auto sk = [&](int st) { return base + kTileQ + st * kTileKV; };
  auto sv = [&](int st) { return base + kTileQ + (kStages + st) * kTileKV; };
  // staging slot i (over another type than bf16)
  auto stg = [&](int i) { return base + kTileQ + 2 * kStages * kTileKV + i * WD::kSlotBytes; };
  const uint32_t bars = base + kTileQ + 2 * kStages * kTileKV + kSlots * WD::kSlotBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * kStages + st); };
  // a staging slot's chunk landed / read by every converting thread
  auto s_full = [&](int i) { return bars + 8 * (1 + 4 * kStages + i); };
  auto s_empty = [&](int i) { return bars + 8 * (1 + 4 * kStages + kSlots + i); };
  // key tile t sits in stage t % kStages; its barriers complete their
  // (t / kStages)-th phase when it lands and when it is released
  auto parity = [](int t) { return (uint32_t)((t / kStages) & 1); };
  // a tile at dst: one TMA box a sub-tile (sub-tiles `sub` bytes apart),
  // counted on bar
  auto tma_tile = [&](uint32_t dst, int sub, const CUtensorMap* map, uint32_t bar, int head,
                      int row, int batch) {
#pragma unroll
    for (int i = 0; i < WD::kBoxes; ++i)
      tma_load_4d(dst + i * sub, map, bar, i * WD::kBoxDims, head, row, batch);
  };

  // blocks start in linear order: a group of gridDim.x heads fastest, then
  // the query tile, heaviest (last) first, then the head group and the batch
  // row; so a group's heavy tiles start before any lighter one, and only a
  // group's K/V is read at a time (it stays in L2)
  const int groups = H / gridDim.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWBQ;
  const int h = blockIdx.z % groups * gridDim.x + blockIdx.x, b = blockIdx.z / groups;
  const int off = chunk_offset<OFFSET>(q_offset);
  const int kb = cache_row<OFFSET>(rows, b, Bkv);
  const int kvh = h / (H / Hkv);
  // keys up to the causal limit of the tile's last real row
  const int kv_end = min(SKV, off + min(q0 + kWBQ, SQ));
  const int n_kt = (kv_end - 1) / kKeys + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      // over bf16 one arrival with the tile's bytes; else every producer thread
      mbar_init(k_full(st), WD::kConv ? 128 : 1);
      mbar_init(v_full(st), WD::kConv ? 128 : 1);
      mbar_init(k_empty(st), 8);   // lane 0 of each consumer warp
      mbar_init(v_empty(st), 8);
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(s_full(i), 1);
      mbar_init(s_empty(i), 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    if constexpr (WD::kConv) {
      reg_dealloc<kWConvProducerRegs>();
      const int ct = tid - 256;   // 0 .. 127; 0 issues the copies
      if (ct == 0) {
        tma_prefetch_desc(&tq);
        mbar_expect_tx(q_full, kTileQ);
        tma_tile(sq, kSubQ, &tq, q_full, h, q0, b);
      }
      // item i of the order the consumers take the tiles: K(0), K(1), V(0),
      // K(2), V(1), ..., K(n_kt - 1), V(n_kt - 2), V(n_kt - 1); returns
      // whether it is V and its tile
      const int n_items = 2 * n_kt;
      auto item = [&](int i, int& tile) {
        tile = i == 0 ? 0 : i == n_items - 1 ? n_kt - 1 : (i & 1) ? (i + 1) >> 1 : (i >> 1) - 1;
        return i != 0 && (i == n_items - 1 || !(i & 1));
      };
      constexpr int kRowUnits = D / 8;   // 8-element units a row
      constexpr int kChunks = WD::kChunks, kCK = WD::kChunkKeys;
      const int n_chunks = n_items * kChunks;
      auto issue = [&](int j) {   // chunk j into slot j % kSlots
        int tile;
        const bool is_v = item(j / kChunks, tile);
        const int i = j % kSlots;
        mbar_expect_tx(s_full(i), WD::kSlotBytes);
        tma_load_4d(stg(i), is_v ? &tv : &tk, s_full(i), 0, kvh,
                    tile * kKeys + j % kChunks * kCK, kb);
      };
      if (ct == 0) {
        tma_prefetch_desc(&tk);
        tma_prefetch_desc(&tv);
        for (int j = 0; j < kSlots && j < n_chunks; ++j) issue(j);
      }
      for (int j = 0; j < n_chunks; ++j) {
        // slot (j - 1) % kSlots, read by all, takes chunk j - 1 + kSlots
        if (ct == 0 && j >= 1 && j - 1 + kSlots < n_chunks) {
          mbar_wait(s_empty((j - 1) % kSlots), (uint32_t)(((j - 1) / kSlots) & 1));
          issue(j - 1 + kSlots);
        }
        int tile;
        const bool is_v = item(j / kChunks, tile);
        const int c = j % kChunks, i = j % kSlots;
        // before a tile's first chunk: its stage released by the consumers
        if (c == 0 && tile >= kStages)
          mbar_wait(is_v ? v_empty(tile % kStages) : k_empty(tile % kStages),
                    parity(tile - kStages));
        mbar_wait(s_full(i), (uint32_t)((j / kSlots) & 1));
        const T* src = reinterpret_cast<const T*>(sbase + (stg(i) - base));
        const uint32_t dst = is_v ? sv(tile % kStages) : sk(tile % kStages);
        const int key0 = tile * kKeys + c * kCK;
        if constexpr (128 % kRowUnits == 0 && kRow == 128) {
          // D = 64, 128: each thread keeps one 8-element column and takes
          // every kPass-th row from r0, a whole number of swizzle atoms
          // apart, so its 16-byte chunk's place in a row never moves; kU
          // units in flight
          constexpr int kPass = 128 / kRowUnits, kU = sizeof(T) == 1 ? 4 : 2;
          static_assert(kPass % 8 == 0 && kCK % (kPass * kU) == 0, "whole atoms, whole batches");
          const int c8 = ct % kRowUnits, r0 = ct / kRowUnits;
          const int box = c8 * 8 / WD::kBoxDims, k16 = c8 % (WD::kBoxDims / 8);
          unsigned char* to = sbase + (dst - base) + box * kSubKV + (c * kCK + r0) * kRow +
                              ((k16 ^ (r0 & 7)) << 4);
          const T* from = src + r0 * D + c8 * 8;
#pragma unroll 1
          for (int r = 0; r < kCK; r += kPass * kU) {
            alignas(16) T x[kU][8];
#pragma unroll
            for (int a = 0; a < kU; ++a)
              load8(x[a], from + (r + a * kPass) * D, key0 + r0 + r + a * kPass < kv_end);
#pragma unroll
            for (int a = 0; a < kU; ++a)
              *reinterpret_cast<uint4*>(to + (r + a * kPass) * kRow) = gptq_kv::bf16x8(x[a]);
          }
        } else {
          // D = 80, 96: unit u of the chunk into row rr of the stage, 16
          // bytes at the place the TMA swizzle would put them
#pragma unroll 2
          for (int u = ct; u < kCK * kRowUnits; u += 128) {
            const int r = u / kRowUnits, rr = c * kCK + r, c8 = u % kRowUnits;
            const int box = c8 * 8 / WD::kBoxDims, k16 = c8 % (WD::kBoxDims / 8);
            alignas(16) T x[8];
            load8(x, src + u * 8, key0 + r < kv_end);
            *reinterpret_cast<uint4*>(sbase + (dst - base) + box * kSubKV + rr * kRow +
                                      ((k16 ^ ((rr * kRow >> 7) & (kRow / 16 - 1))) << 4)) =
                gptq_kv::bf16x8(x);
          }
        }
        mbar_arrive(s_empty(i));
        // after a tile's last chunk: the stores visible to wgmma, the stage full
        if (c == kChunks - 1) {
          fence_proxy_async();
          mbar_arrive(is_v ? v_full(tile % kStages) : k_full(tile % kStages));
        }
      }
    } else {
      // producer warpgroup: one lane of its first warp issues every copy, in
      // the order the consumers take them: K(t), then V(t - 1)
      reg_dealloc<kWProducerRegs>();
      if (warp == 8 && lane == 0) {
        tma_prefetch_desc(&tq);
        tma_prefetch_desc(&tk);
        tma_prefetch_desc(&tv);
        mbar_expect_tx(q_full, kTileQ);
        tma_tile(sq, kSubQ, &tq, q_full, h, q0, b);
        for (int t = 0; t <= n_kt; ++t) {
          if (t < n_kt) {
            const int st = t % kStages;
            if (t >= kStages) mbar_wait(k_empty(st), parity(t - kStages));
            mbar_expect_tx(k_full(st), kTileKV);
            tma_tile(sk(st), kSubKV, &tk, k_full(st), kvh, t * kKeys, kb);
          }
          if (t >= 1) {
            const int u = t - 1, st = u % kStages;
            if (u >= kStages) mbar_wait(v_empty(st), parity(u - kStages));
            mbar_expect_tx(v_full(st), kTileKV);
            tma_tile(sv(st), kSubKV, &tv, v_full(st), kvh, u * kKeys, kb);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    reg_alloc<WD::kConv ? kWConvConsumerRegs : kWConsumerRegs>();
    const int wg = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_lo = q0 + wg * 64 + wi * 16 + g, row_hi = row_lo + 8;
    const int pos_lo = off + row_lo, pos_hi = off + row_hi;
    const int wg_first = off + q0 + wg * 64;   // absolute position of the warpgroup's first row

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float s[kKeys / 2];
    uint32_t pf[kKeys / 16][4];
    float m_lo = kNeg, m_hi = kNeg, l_lo = 0.0f, l_hi = 0.0f;

    auto issue_s = [&](int st) {   // S = Q K^T: 64 rows x kKeys keys
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {   // dims 16 kk ..: a sub-tile, 32 B steps in a row
        const int box = kk * 16 / WD::kBoxDims, col = (kk * 16 % WD::kBoxDims) * 2;
        const uint64_t da = desc_sw<kRow>(sq + box * kSubQ + wg * 64 * kRow + col, 16, kAtom);
        const uint64_t db = desc_sw<kRow>(sk(st) + box * kSubKV + col, 16, kAtom);
        if constexpr (kKeys == 128) {
          wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
        } else if constexpr (kKeys == 80) {
          wgmma_m64n80k16_ss<0>(s, da, db, kk > 0);
        } else {
          wgmma_m64n64k16_ss<0>(s, da, db, kk > 0);
        }
      }
    };
    auto issue_pv = [&](int st) {   // O += P V: V is [key][dim], MN-major for the product
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j)
        wgmma_rs<1>(o, pf[j], desc_sw<kRow>(sv(st) + j * 16 * kRow, kSubKV, kAtom), 1);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // causal / ragged mask and online softmax of key tile t: s becomes p
    // (fp32); returns the factors that rescale O. The running max is kept in
    // log2 units, m = max(s) * scale * log2(e), so p = 2^(s * c - m) is one
    // FFMA and one ex2 (n8 chunk i: keys k0 + 8 i + 2 t4 + {0, 1}; elements
    // 0-1 row_lo, 2-3 row_hi)
    const float c = scale * 1.4426950408889634f;
    auto softmax = [&](int t, float& a_lo, float& a_hi) {
      const int k0 = t * kKeys;
      if ((k0 + kKeys - 1 > wg_first) || (k0 + kKeys > kv_end)) {
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + i * 8 + t4 * 2 + (e & 1);
            if (key > (e < 2 ? pos_lo : pos_hi) || key >= kv_end) s[4 * i + e] = -INFINITY;
          }
      }
      float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * i], s[4 * i + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo * c), mn_hi = fmaxf(m_hi, mx_hi * c);
      a_lo = ex2(m_lo - mn_lo);
      a_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        s[4 * i] = ex2(fmaf(s[4 * i], c, -mn_lo));
        s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c, -mn_lo));
        s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c, -mn_hi));
        s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c, -mn_hi));
        sum_lo += s[4 * i] + s[4 * i + 1];
        sum_hi += s[4 * i + 2] + s[4 * i + 3];
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
    };
    // O *= a, then p as bf16 A fragments: keys 16j..16j+15 are n8 chunks 2j
    // and 2j+1
    auto rescale_and_pack = [&](float a_lo, float a_hi) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= a_lo;
        o[4 * i + 1] *= a_lo;
        o[4 * i + 2] *= a_hi;
        o[4 * i + 3] *= a_hi;
      }
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        pf[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
    };
    // hand the tensor cores to the other warpgroup (warpgroup 1's last
    // hand-over would have no taker: warpgroup 0 has issued its last products)
    auto hand_over = [&](int t) {
      if (wg == 0 || t < n_kt - 1) named_barrier_arrive(kBarTurn + (wg ^ 1), 256);
    };

    if (wg == 1) named_barrier_arrive(kBarTurn, 256);   // warpgroup 0 issues first
    mbar_wait(q_full, 0);
    float a_lo, a_hi;
    // key tile 0: S only
    mbar_wait(k_full(0), 0);
    named_barrier(kBarTurn + wg, 256);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    hand_over(0);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty(0));
    softmax(0, a_lo, a_hi);
    rescale_and_pack(a_lo, a_hi);
    // key tiles 1 ..: S(t) and P(t-1) V(t-1) in flight together
    for (int kt = 1; kt < n_kt; ++kt) {
      const int st = kt % kStages, pst = (kt - 1) % kStages;
      mbar_wait(k_full(st), parity(kt));
      mbar_wait(v_full(pst), parity(kt - 1));
      named_barrier(kBarTurn + wg, 256);
      wgmma_fence();
      issue_s(st);
      wgmma_commit();
      issue_pv(pst);
      wgmma_commit();
      hand_over(kt);
      wgmma_wait<1>();
      fence_regs(s);
      release(k_empty(st));
      softmax(kt, a_lo, a_hi);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      release(v_empty(pst));
      rescale_and_pack(a_lo, a_hi);
    }

    // the last tile's P V
    const int lst = (n_kt - 1) % kStages;
    mbar_wait(v_full(lst), parity(n_kt - 1));
    if (!WD::kConv && OFFSET && kv_end < min(SKV, (n_kt - 1) * kKeys + kKeys)) {
      // the cache's slots from kv_end to the tile's edge may hold NaN: zero
      // their V rows (in every sub-tile; a swizzle moves 16-byte chunks
      // within a row only) before P V reads them (over another type than
      // bf16 the producer stored zeros there)
      constexpr int kRowChunks = kRow / 16, kChunks = WD::kBoxes * kRowChunks;
      const int r0 = kv_end - (n_kt - 1) * kKeys;
      const int chunks = (kKeys - r0) * kChunks;
      for (int c = tid; c < chunks; c += 256) {
        const int r = r0 + c / kChunks, box = c % kChunks / kRowChunks, c16 = c % kRowChunks;
        const uint32_t at = sv(lst) - base + box * kSubKV + r * kRow + c16 * 16;
        *reinterpret_cast<uint4*>(sbase + at) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_barrier(kBarZero, 256);
    }
    wgmma_fence();
    issue_pv(lst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);

#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
    }
    const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
    const size_t q_stride = (size_t)H * D;
    if (row_lo < SQ) {
      __nv_bfloat16* orow = out + ((size_t)b * SQ + row_lo) * q_stride + (size_t)h * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + i * 8 + t4 * 2) =
            pack_bf16(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
    }
    if (row_hi < SQ) {
      __nv_bfloat16* orow = out + ((size_t)b * SQ + row_hi) * q_stride + (size_t)h * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + i * 8 + t4 * 2) =
            pack_bf16(o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
    }
  }
}

// -- host --------------------------------------------------------------------
using gptq_hopper::encode_tiled;
using gptq_hopper::EncodeTiled;

// The tensor map of a (B, rows, heads, D) bf16 tensor: a box of one sub-tile
// (WgmmaDims<D>::kBoxDims dims) x 1 head x box_rows rows x 1 batch row (128
// for Q, WgmmaDims<D>::kKeys for K and V), in the swizzle of its row width;
// rows past `rows` read as zeros. The strides (2 D, 2 D heads, 2 D heads rows
// bytes) are multiples of 16 at every D it takes.
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int box_rows) {
  using WD = WgmmaDims<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)WD::kBoxDims, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = WD::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : WD::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a (Bkv, rows, heads, D) cache k or v of type T as the
// wgmma body over T reads it: over bf16 the map above; over another type a
// box of one staging chunk (D elements x 1 head x kChunkKeys rows x 1 batch
// row, unswizzled: the producer's threads read it), the same coordinates,
// the strides D, D heads, D heads rows times the itemsize (multiples of 16
// bytes).
template <int D, typename T>
bool tensor_map_kv(CUtensorMap* map, const void* ptr, int B, int rows, int heads) {
  using WD = WgmmaDims<D, T>;
  if constexpr (!WD::kConv) {
    return tensor_map<D>(map, ptr, B, rows, heads, WD::kKeys);
  } else {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    constexpr cuuint64_t kIsz = sizeof(T);
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {D * kIsz, (cuuint64_t)heads * D * kIsz,
                                   (cuuint64_t)rows * heads * D * kIsz};
    const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)WD::kChunkKeys, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, kIsz == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
              const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
}

// The two bodies: the wrapper's plan names one
enum Path { kSync = 0, kWgmma = 1 };

// Whether the wgmma body takes a cache of type T at head dim D
template <int D, typename T>
constexpr bool wgmma_takes() {
  return std::is_same<T, __nv_bfloat16>::value ? wgmma_dim(D) : wgmma_kv_dim(D);
}

// Dynamic shared memory of one block of body `path` at this library's D over
// a cache of type T (0 where the body does not run).
template <int D = kHeadDim, typename T = __nv_bfloat16>
int smem_bytes(int path) {
  if (path == kWgmma) {
    if constexpr (wgmma_takes<D, T>()) return WgmmaDims<D, T>::kSmemBytes;
    return 0;
  }
  return SyncDims<D>::kSmemBytes;
}

// The wgmma body's layout at this library's D over a cache of type T, as
// ops/cuda/flash.py:wgmma_layout mirrors it: K and V stages, keys of a
// staging chunk, staging slots, staging bytes, dynamic shared memory (all 0
// where the body does not take T).
template <typename T>
void wgmma_layout(int* out) {
  if constexpr (wgmma_takes<kHeadDim, T>()) {
    using WD = WgmmaDims<kHeadDim, T>;
    out[0] = WD::kStages;
    out[1] = WD::kConv ? WD::kChunkKeys : 0;
    out[2] = WD::kSlots;
    out[3] = WD::kSlots * WD::kSlotBytes;
    out[4] = WD::kSmemBytes;
  } else {
    for (int i = 0; i < 5; ++i) out[i] = 0;
  }
}

// One launch of the wgmma body at head dim D (bf16 q; k, v of type T); sets
// the dynamic shared memory attribute once, as launch below.
template <int D, bool OFFSET, typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, __nv_bfloat16* out,
                         int B, int SQ, int Bkv, int SKV, int H, int Hkv, const int* q_offset,
                         const int* rows, float scale, cudaStream_t stream) {
  constexpr int kSmem = WgmmaDims<D, T>::kSmemBytes;
  auto kern = flash_wgmma_kernel<D, OFFSET, T>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, B, SQ, H, kWBQ) || !tensor_map_kv<D, T>(&tk, k, Bkv, SKV, Hkv) ||
      !tensor_map_kv<D, T>(&tv, v, Bkv, SKV, Hkv))
    return cudaErrorInvalidValue;
  // heads a group, a divisor of H: the fewest whose query tiles fill the
  // SMs once; past 16 waves of blocks one (the query tile fastest: a head's
  // tiles run side by side on its K/V, and the last wave's tail is short)
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int nq = (SQ + kWBQ - 1) / kWBQ;
  const bool many = (long long)B * H * nq >= 16LL * sms;
  int g = H;
  for (int d = 1; d < H; ++d)
    if (H % d == 0 && (many || d * nq >= sms) && (long long)B * (H / d) <= 65535) {
      g = d;
      break;
    }
  dim3 grid(g, nq, B * (H / g));
  kern<<<grid, kWThreads, kSmem, stream>>>(tq, tk, tv, out, SQ, Bkv, SKV, H, Hkv, q_offset, rows,
                                           scale);
  return cudaGetLastError();
}

// One launch; sets the dynamic shared memory attribute once per instantiation
// (not per launch, so a CUDA-graph capture sees none).
// k/v are (Bkv, SKV, Hkv, D) of element type T: the tensor maps cover the
// whole cache, so a launch captured in a CUDA graph replays over the same
// tensors whatever offset and rows the device buffers hold (kernel 4).
// Kernel 5 passes null offset and rows, Bkv = B and bf16. The wgmma body
// takes a cache of another type than bf16 at D = 64, 80, 96 and 128; asked
// for it at D = 256 (or at a head dim outside wgmma_dim), launch returns
// cudaErrorInvalidValue: no body stands in for another.
template <bool OFFSET, typename T = __nv_bfloat16>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int SQ,
                   int Bkv, int SKV, int H, int Hkv, const int* q_offset, const int* rows,
                   float scale, int path, cudaStream_t stream) {
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (path == kWgmma) {
    if constexpr (wgmma_takes<kHeadDim, T>()) {
      return launch_wgmma<kHeadDim, OFFSET, T>(q, k, v, ob, B, SQ, Bkv, SKV, H, Hkv, q_offset,
                                               rows, scale, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (path != kSync) return cudaErrorInvalidValue;
  constexpr int kSmemBytes = SyncDims<kHeadDim>::kSmemBytes;
  auto kern = flash_sync_kernel<kHeadDim, OFFSET, T>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((SQ + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      ob, SQ, Bkv, SKV, H, Hkv, q_offset, rows, scale);
  return cudaGetLastError();
}

}  // inline namespace of the head dim
}  // namespace gptq_flash
