// Single-token decode attention over a KV cache, for Hopper (sm_90a):
// split-KV across blocks, with the cache staged through cp.async.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:80  decode_attention_bhd
// (its pallas_call at :114) and computes its function: one query row per
// (batch, q-head) attends over the first n_valid[b] slots of its batch
// row's cache, GQA (q-head h reads kv-head h / group), fp32 online
// softmax with scale hd^-0.5, the output in q's type; a row with n_valid
// = 0 gives zeros. Held to the PyTorch twin in ../ref.py (the split path
// also to decode_attention_split_ref, the combine to combine_partials_ref).
//
// Bound: HBM bytes. Each live K/V row (hd values) is read once and feeds
// group x 2 x hd multiply-adds, so at group 3 and bf16 the kernel does
// about 3 flops per byte, far below the card's ~295 bf16 flops per byte.
// Reaching the HBM rate takes enough blocks to fill the 132 SMs and
// enough bytes in flight in each.
//
// Design:
//   * Inputs stay in the model's storage layout: q (B, 1, H, hd) and the
//     caches (B, C, K, hd); no transposed copy is made.
//   * Grid (B·K, ceil(group / GT), splits). A block serves one kv head's
//     GQA group (GT = 1, 2, 4 or 8 q-heads, at most 4 at hd 256; chosen by
//     the wrapper), so each K/V row is read from HBM once per group, and
//     covers the slots [s·span, min((s+1)·span, n_valid[b])) of split s.
//     The wrapper plans the splits from the cache's capacity (n_valid
//     lives on the card and is never read by the host): one split, written
//     straight to the output, for every cache of 4,096 slots or fewer; for
//     longer caches the split count whose grid runs in the fewest whole
//     waves of resident blocks (decode_attention_blocks_per_sm) times the
//     span -- a grid a few blocks past one wave runs its tail alone for a
//     whole block's time. A split with no live slot writes m = -inf, l = 0
//     (or zeros) and exits.
//   * Within a block the split is walked in tiles of 8 KB of K (and 8 KB
//     of V): 64 rows at bf16 hd 64 down to 8 rows at fp32 hd 256. The
//     tiles come in through 16-byte cp.async copies (a row is one
//     contiguous run of hd values, so the copies are coalesced; rows past
//     the split's end are zero-filled) into a 3-stage ring: two tiles are
//     in flight while one computes.
//   * A row of the tile is owned by hd / 8 consecutive threads, each
//     holding 8 of its dims (bf16: one 16-byte run; fp32: two 16-byte
//     runs hd/2 apart, so a warp's shared-memory reads stay conflict
//     free). Scores are those threads' partial dots against q (in shared
//     memory as fp32), summed by shuffles. Each row group keeps its own
//     (m, l, acc) per q-head over the rows it owns, in the log2 domain
//     (one FFMA and one ex2 a probability; the rescale only where m
//     rises); the row groups of a warp merge by shuffles, then the eight
//     warps in shared memory.
//   * One split: the block writes out = acc / l in q's type. Several: it
//     writes fp32 partials acc (splits, B, H, hd), m (natural log units)
//     and l (splits, B, H)
//     into scratch the wrapper allocates, and decode_combine_kernel (grid
//     B·H) merges them: out = Σ e^{m_s - m*} acc_s / Σ e^{m_s - m*} l_s,
//     zeros where every split was empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kTileBytes = 8192;  // of K (and of V) per stage
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// The e-th of the 8 dims that thread `sub` of a row group owns.
template <class T, int HD>
__device__ __forceinline__ int dim_of(int sub, int e) {
  if constexpr (sizeof(T) == 2) {
    return sub * 8 + e;
  } else {
    return (e < 4 ? sub * 4 : HD / 2 + sub * 4) + (e & 3);
  }
}

// The 8 dims of `row` (in shared memory) that thread `sub` owns, as floats.
template <int HD>
__device__ __forceinline__ void lds8(const bf16* row, int sub, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + sub * 8);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
// The 8 dims, in T's layout, that thread `sub` owns, read from an fp32
// row (q in shared memory, or an fp32 K/V tile row): two 16-byte runs.
template <class T, int HD>
__device__ __forceinline__ void lds8_dims(const float* row, int sub, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + dim_of<T, HD>(sub, 0));
  const float4 b = *reinterpret_cast<const float4*>(row + dim_of<T, HD>(sub, 4));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
template <int HD>
__device__ __forceinline__ void lds8(const float* row, int sub, float (&o)[8]) {
  lds8_dims<float, HD>(row, sub, o);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory: q (GT x HD fp32), then the tile ring, which the
// warps' merge buffers reuse after the last tile.
template <int HD, int GT>
__host__ __device__ constexpr size_t q_bytes() {
  return (static_cast<size_t>(GT) * HD * 4 + 127) / 128 * 128;
}
template <int HD, int GT>
constexpr size_t smem_bytes() {
  constexpr size_t ring = static_cast<size_t>(kStages) * 2 * kTileBytes;
  constexpr size_t merge = static_cast<size_t>(kWarps) * GT * (HD + 2) * 4;
  return q_bytes<HD, GT>() + (ring > merge ? ring : merge);
}

// grid (B * n_kv, ceil(group / GT), splits); block kThreads; dynamic
// shared memory smem_bytes<HD, GT>(). part_acc / part_ml are read only
// when splits > 1: acc (splits, B, H, HD), then m and l (2, splits, B, H).
template <class T, int HD, int GT>
__global__ void __launch_bounds__(kThreads, GT >= 8 ? 1 : 2)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ n_valid,
                            T* __restrict__ out, float* __restrict__ part_acc,
                            float* __restrict__ part_ml, int B, int C, int n_kv, int group,
                            int span, float scale_log2) {
  constexpr int R = kTileBytes / (HD * static_cast<int>(sizeof(T)));  // rows a tile
  constexpr int TPR = HD / 8;          // threads a row
  constexpr int RPP = kThreads / TPR;  // rows a pass of the block
  constexpr int RPT = R / RPP;         // rows a thread, per tile
  constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  constexpr int CPT = R * CPR;                                 // chunks a tile
  static_assert(RPT >= 1 && R % RPP == 0 && CPT % kThreads == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [GT][HD]
  unsigned char* ring = smem + q_bytes<HD, GT>();

  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x % n_kv;
  const int g0 = blockIdx.y * GT;
  const int ng = min(GT, group - g0);
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int H = n_kv * group;
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t head0 = static_cast<size_t>(b) * H + kvh * group + g0;  // (b, h) of q-head g0
  const int nv = min(max(n_valid[b], 0), C);
  const int lo = split * span;
  const int hi = min(lo + span, nv);

  if (lo >= hi) {  // no live slot in this split
    for (int i = tid; i < ng * HD; i += kThreads) {
      if (splits == 1) {
        out[head0 * HD + i] = from_float<T>(0.f);
      } else {
        part_acc[(split * BH + head0) * HD + i] = 0.f;
      }
    }
    if (splits > 1 && tid < ng) {
      part_ml[split * BH + head0 + tid] = -CUDART_INF_F;
      part_ml[(splits + split) * BH + head0 + tid] = 0.f;
    }
    return;
  }

  const size_t row_stride = static_cast<size_t>(n_kv) * HD;
  const T* k_base = k + static_cast<size_t>(b) * C * row_stride + kvh * HD;
  const T* v_base = v + static_cast<size_t>(b) * C * row_stride + kvh * HD;
  const int n_tiles = (hi - lo + R - 1) / R;
  auto load = [&](int t) {
    const int row0 = lo + t * R;
    const int n_ok = hi - row0;
    unsigned char* stage = ring + (t % kStages) * 2 * kTileBytes;
#pragma unroll
    for (int it = 0; it < 2 * CPT / kThreads; ++it) {
      const int i = it * kThreads + tid;
      const bool is_v = i >= CPT;
      const int j = is_v ? i - CPT : i;
      const int r = j / CPR;
      const int c = j % CPR;
      const bool ok = r < n_ok;
      const T* src = (is_v ? v_base : k_base) + (row0 + (ok ? r : 0)) * row_stride +
                     c * (16 / static_cast<int>(sizeof(T)));
      cp_async16(stage + (is_v ? kTileBytes : 0) + j * 16, src, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  // the group's q rows (heads g0 ...), zero past the group
  const T* q_rows = q + head0 * HD;
  for (int i = tid; i < GT * HD; i += kThreads) {
    q_s[i] = i / HD < ng ? to_float(q_rows[i]) : 0.f;
  }

  const int rg = tid / TPR;  // row group: rows rg, rg + RPP, ... of each tile
  const int sub = tid % TPR;
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile t (and q_s) visible to every thread
    const T* k_t = reinterpret_cast<const T*>(ring + (t % kStages) * 2 * kTileBytes);
    const T* v_t = k_t + R * HD;
    const int row0 = lo + t * R;

    float s[RPT][GT];
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      float kf[8];
      lds8<HD>(k_t + (rg + p * RPP) * HD, sub, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float qf[8];
        lds8_dims<T, HD>(q_s + g * HD, sub, qf);
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a += qf[e] * kf[e];
        s[p][g] = a;
      }
    }
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) s[p][g] += __shfl_xor_sync(kFull, s[p][g], off);
      }
    }

    // online softmax of the row group over its rows of this tile, in the
    // log2 domain (m = max of score x scale x log2 e): a probability is one
    // FFMA and one ex2, and (m, l, acc) are rescaled only when m rises
    bool live[RPT];
#pragma unroll
    for (int p = 0; p < RPT; ++p) live[p] = row0 + rg + p * RPP < hi;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int p = 0; p < RPT; ++p) mx = live[p] ? fmaxf(mx, s[p][g]) : mx;
      const float m_new = fmaxf(m[g], mx * scale_log2);
      if (m_new > m[g]) {
        const float corr = exp2f(m[g] - m_new);  // 0 while m = -inf
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
        m[g] = m_new;
      }
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        // m is finite wherever a row is live
        s[p][g] = live[p] ? exp2f(fmaf(s[p][g], scale_log2, -m[g])) : 0.f;
        l[g] += s[p][g];
      }
    }
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      float vf[8];
      lds8<HD>(v_t + (rg + p * RPP) * HD, sub, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += s[p][g] * vf[e];
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // merge the row groups of each warp: (m, l, acc) by shuffles
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo_ = __shfl_xor_sync(kFull, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float a = m[g] == -CUDART_INF_F ? 0.f : exp2f(m[g] - mm);
      const float c = mo == -CUDART_INF_F ? 0.f : exp2f(mo - mm);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(kFull, acc[g][e], off) * c;
      }
      m[g] = mm;
    }
  }

  // then the warps, in shared memory (the ring is free now)
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* acc_s = reinterpret_cast<float*>(ring);  // [kWarps][GT][HD]
  float* m_s = acc_s + kWarps * GT * HD;          // [kWarps][GT]
  float* l_s = m_s + kWarps * GT;                 // [kWarps][GT]
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_s[(warp * GT + g) * HD + dim_of<T, HD>(sub, e)] = acc[g][e];
      if (lane == 0) {
        m_s[warp * GT + g] = m[g];
        l_s[warp * GT + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * GT + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_s[w * GT + g];
      const float a = mw == -CUDART_INF_F ? 0.f : exp2f(mw - mx);  // 0 for a warp with no row
      num += acc_s[(w * GT + g) * HD + d] * a;
      den += l_s[w * GT + g] * a;
    }
    if (splits == 1) {
      out[(head0 + g) * HD + d] = from_float<T>(den > 0.f ? num / den : 0.f);
    } else {
      part_acc[(split * BH + head0 + g) * HD + d] = num;
      if (d == 0) {
        part_ml[split * BH + head0 + g] = mx * kLn2;  // natural-log units
        part_ml[(splits + split) * BH + head0 + g] = den;
      }
    }
  }
}

// grid (B * H); block HD. Merges the splits' partials of one (b, h) row.
template <class T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, T* __restrict__ out,
                                      int BH, int splits) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const int hd = blockDim.x;
  const float* m = part_ml;
  const float* l = part_ml + static_cast<size_t>(splits) * BH;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[static_cast<size_t>(s) * BH + bh]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t row = static_cast<size_t>(s) * BH + bh;
    const float a = m[row] == -CUDART_INF_F ? 0.f : expf(m[row] - mx);  // 0: empty split
    num += part_acc[row * hd + d] * a;
    den += l[row] * a;
  }
  out[static_cast<size_t>(bh) * hd + d] = from_float<T>(den > 0.f ? num / den : 0.f);
}

template <class T, int HD, int GT>
cudaError_t launch_one(const void* q, const void* k, const void* v, const int* n_valid,
                       void* out, float* part_acc, float* part_ml, int B, int C, int n_kv,
                       int group, int splits, int span, float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, HD, GT>;
  constexpr size_t smem = smem_bytes<HD, GT>();
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * n_kv, (group + GT - 1) / GT, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), n_valid,
      static_cast<T*>(out), part_acc, part_ml, B, C, n_kv, group, span, scale * kLog2e);
  return cudaGetLastError();
}

// Blocks of decode_attention_kernel<T, HD, GT> one SM holds at once (0
// on an error).
template <class T, int HD, int GT>
int blocks_per_sm() {
  auto kernel = decode_attention_kernel<T, HD, GT>;
  constexpr size_t smem = smem_bytes<HD, GT>();
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
    return 0;
  return n;
}

template <class T, int HD>
int blocks_per_sm_gt(int gt) {
  if (gt == 1) return blocks_per_sm<T, HD, 1>();
  if (gt == 2) return blocks_per_sm<T, HD, 2>();
  if (gt == 4) return blocks_per_sm<T, HD, 4>();
  if constexpr (HD <= 128) {
    if (gt == 8) return blocks_per_sm<T, HD, 8>();
  }
  return 0;
}

template <class T>
int blocks_per_sm_hd(int hd, int gt) {
  if (hd == 64) return blocks_per_sm_gt<T, 64>(gt);
  if (hd == 128) return blocks_per_sm_gt<T, 128>(gt);
  if (hd == 256) return blocks_per_sm_gt<T, 256>(gt);
  return 0;
}

template <class T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* n_valid,
                      void* out, float* part_acc, float* part_ml, int B, int C, int n_kv,
                      int group, int gt, int splits, int span, float scale,
                      cudaStream_t stream) {
#define DECODE_GT(G)                                                                       \
  if (gt == G)                                                                             \
    return launch_one<T, HD, G>(q, k, v, n_valid, out, part_acc, part_ml, B, C, n_kv, group, \
                                splits, span, scale, stream);
  DECODE_GT(1)
  DECODE_GT(2)
  DECODE_GT(4)
  if constexpr (HD <= 128) {
    DECODE_GT(8)  // at hd 256 a group takes blocks of 4 q-heads
  }
#undef DECODE_GT
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t launch_type(const void* q, const void* k, const void* v, const int* n_valid,
                        void* out, float* part_acc, float* part_ml, int B, int C, int n_kv,
                        int group, int gt, int hd, int splits, int span, float scale,
                        cudaStream_t stream) {
  if (hd == 64)
    return launch_hd<T, 64>(q, k, v, n_valid, out, part_acc, part_ml, B, C, n_kv, group, gt,
                            splits, span, scale, stream);
  if (hd == 128)
    return launch_hd<T, 128>(q, k, v, n_valid, out, part_acc, part_ml, B, C, n_kv, group, gt,
                             splits, span, scale, stream);
  if (hd == 256)
    return launch_hd<T, 256>(q, k, v, n_valid, out, part_acc, part_ml, B, C, n_kv, group, gt,
                             splits, span, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, 1, H, hd), k/v (B, C, n_kv, hd), out (B, 1, H, hd), all of one
// type (dtype 0: fp32, 1: bf16), contiguous and 16-byte aligned; n_valid
// (B,) int32; H = n_kv * group; hd 64, 128 or 256; gt (q-heads a block)
// 1, 2, 4 or 8 (at most 4 at hd 256); span a multiple of 64. With splits
// == 1 the kernel writes out; with more it writes fp32 partials part_acc
// (splits, B, H, hd) and part_ml (2, splits, B, H) for
// decode_attention_combine_launch. Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported hd, gt or
// dtype).
int decode_attention_launch(const void* q, const void* k, const void* v, const int* n_valid,
                            void* out, void* part_acc, void* part_ml, int B, int C, int n_kv,
                            int group, int gt, int hd, int dtype, int splits, int span,
                            float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    return launch_type<float>(q, k, v, n_valid, out, pa, pm, B, C, n_kv, group, gt, hd,
                              splits, span, scale, s);
  if (dtype == 1)
    return launch_type<bf16>(q, k, v, n_valid, out, pa, pm, B, C, n_kv, group, gt, hd, splits,
                             span, scale, s);
  return cudaErrorInvalidValue;
}

// Blocks of the split kernel for (hd, dtype, gt) that one SM holds at
// once, from the CUDA occupancy calculator (0 if unsupported): the
// wrapper plans its splits in whole waves of these.
int decode_attention_blocks_per_sm(int hd, int dtype, int gt) {
  if (dtype == 0) return blocks_per_sm_hd<float>(hd, gt);
  if (dtype == 1) return blocks_per_sm_hd<bf16>(hd, gt);
  return 0;
}

// Merges the partials of decode_attention_launch into out (BH rows of hd
// values in q's type). Launches on `stream`, returns cudaGetLastError().
int decode_attention_combine_launch(const void* part_acc, const void* part_ml, void* out,
                                    int BH, int hd, int dtype, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pm = static_cast<const float*>(part_ml);
  if (hd != 64 && hd != 128 && hd != 256) return cudaErrorInvalidValue;
  if (dtype == 0) {
    decode_combine_kernel<float><<<BH, hd, 0, s>>>(pa, pm, static_cast<float*>(out), BH, splits);
  } else if (dtype == 1) {
    decode_combine_kernel<bf16><<<BH, hd, 0, s>>>(pa, pm, static_cast<bf16*>(out), BH, splits);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
