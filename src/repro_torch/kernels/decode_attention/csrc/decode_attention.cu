// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:80  decode_attention_bhd
// and computes its function: one query row per (batch, q-head) attends
// over the first n_valid[b] slots of its batch row's cache, GQA (q-head h
// reads kv-head h / group), fp32 online softmax with scale hd^-0.5, the
// output in q's type; a row with n_valid = 0 gives zeros. Held to the
// PyTorch twin in ../ref.py.
//
// Bound: HBM bytes. Each live K/V row (hd values) is read once and feeds
// group x 2 x hd multiply-adds, so at group 3 and bf16 the kernel does
// about 3 flops per byte, far below the card's ~295 bf16 flops per byte.
//
// Design (simple and right first):
//   * Inputs stay in the model's storage layout: q (B, 1, H, hd) and the
//     caches (B, C, K, hd); no transposed copy is made.
//   * One block per (batch, kv head) serves the kv head's whole GQA group
//     (up to GT q-heads, 8 at most and 4 at hd 256; larger groups take
//     more blocks along y), so each
//     K/V row is read from HBM once per group, not once per q-head as the
//     TPU grid does.
//   * The block loops over the cache only up to n_valid[b], in tiles of
//     32 rows: warp w takes tiles w, w + 8, ... . For the scores a lane
//     owns one cache row (16-byte loads of the K row, q from shared
//     memory); the tile's max and sum are warp shuffles; for P·V a lane
//     owns hd/32 output dims and reads each V row coalesced.
//   * Each warp keeps its own (m, l, acc) per q-head in registers and the
//     eight warps are merged in shared memory at the end (a split-KV
//     within the block; blocks share nothing).
// Faster designs -- split-KV across blocks to fill all 132 SMs at small
// batch, TMA loads of the cache -- are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;  // cache rows per warp tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eight consecutive elements as floats: one 16-byte load for bf16, two
// for fp32 (the row offsets are multiples of hd, so 16-byte aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// grid (B * n_kv, ceil(group / GT)); block kWarps x 32 threads.
template <class T, int HD, int GT>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ n_valid,
                            T* __restrict__ out, int C, int n_kv, int group,
                            float scale) {
  constexpr int E = HD / 32;  // P·V output dims per lane
  __shared__ float q_s[GT][HD];
  __shared__ float p_s[kWarps][GT][kTile];
  __shared__ float m_s[kWarps][GT];
  __shared__ float l_s[kWarps][GT];
  __shared__ float acc_s[kWarps][GT][HD];

  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x % n_kv;
  const int g0 = blockIdx.y * GT;
  const int ng = min(GT, group - g0);
  const int H = n_kv * group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the group's q rows (heads kvh * group + g0 ...), zero past the group
  const T* q_rows = q + (static_cast<size_t>(b) * H + kvh * group + g0) * HD;
  for (int i = threadIdx.x; i < GT * HD; i += blockDim.x) {
    q_s[i / HD][i % HD] = i / HD < ng ? to_float(q_rows[i]) : 0.f;
  }
  __syncthreads();

  const int nv = min(max(n_valid[b], 0), C);
  const size_t row_stride = static_cast<size_t>(n_kv) * HD;
  const T* k_base = k + static_cast<size_t>(b) * C * row_stride + kvh * HD;
  const T* v_base = v + static_cast<size_t>(b) * C * row_stride + kvh * HD;

  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < nv; t0 += kWarps * kTile) {
    const int c = t0 + lane;
    const bool live = c < nv;
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = k_base + c * row_stride;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kv8[8];
        load8(kr + d0, kv8);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
          for (int j = 0; j < 8; ++j) s[g] += q_s[g][d0 + j] * kv8[j];
        }
      }
    }
    // online softmax over the tile; lane 0's row is live, so m_new is finite
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float sg = live ? s[g] * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float corr = expf(m[g] - m_new);  // 0 on the first tile
      const float p = live ? expf(sg - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      p_s[warp][g][lane] = p;
    }
    __syncwarp();
    const int rows = min(kTile, nv - t0);
#pragma unroll 8  // keeps eight V-row loads in flight
    for (int r = 0; r < rows; ++r) {
      const T* vr = v_base + (t0 + r) * row_stride + lane * E;
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = to_float(vr[e]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = p_s[warp][g][r];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vv[e];
      }
    }
    __syncwarp();
  }

  // merge the warps: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += blockDim.x) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float o = 0.f;  // no live slot: zeros
    if (mx > -CUDART_INF_F) {
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float a = expf(m_s[w][g] - mx);  // 0 for a warp with no tile
        num += acc_s[w][g][d] * a;
        den += l_s[w][g] * a;
      }
      o = num / den;
    }
    out[(static_cast<size_t>(b) * H + kvh * group + g0 + g) * HD + d] =
        from_float<T>(o);
  }
}

template <class T, int HD, int GT>
cudaError_t launch_one(const void* q, const void* k, const void* v,
                       const int* n_valid, void* out, int B, int C, int n_kv,
                       int group, float scale, cudaStream_t stream) {
  const dim3 grid(B * n_kv, (group + GT - 1) / GT);
  decode_attention_kernel<T, HD, GT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), n_valid, static_cast<T*>(out), C, n_kv, group,
      scale);
  return cudaGetLastError();
}

template <class T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* n_valid, void* out, int B, int C, int n_kv,
                      int group, float scale, cudaStream_t stream) {
  // the smallest register tile that holds the group, 8 q-heads at most;
  // at hd 256 at most 4, so that the static shared memory (acc_s: kWarps
  // x GT x HD fp32, 32 KB at GT 4) stays under 48 KB -- a larger group
  // takes ceil(group / 4) blocks along y
  if (group <= 1)
    return launch_one<T, HD, 1>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  if (group <= 2)
    return launch_one<T, HD, 2>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  if constexpr (HD > 128) {
    return launch_one<T, HD, 4>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  } else {
    if (group <= 4)
      return launch_one<T, HD, 4>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
    return launch_one<T, HD, 8>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  }
}

template <class T>
cudaError_t launch_type(const void* q, const void* k, const void* v,
                        const int* n_valid, void* out, int B, int C, int n_kv,
                        int group, int hd, float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch_hd<T, 64>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  if (hd == 128)
    return launch_hd<T, 128>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  if (hd == 256)
    return launch_hd<T, 256>(q, k, v, n_valid, out, B, C, n_kv, group, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, 1, H, hd), k/v (B, C, n_kv, hd), out (B, 1, H, hd), all of one
// type (dtype 0: fp32, 1: bf16), contiguous; n_valid (B,) int32; H =
// n_kv * group; hd 64, 128 or 256. Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported hd/dtype).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* n_valid, void* out, int B, int C,
                            int n_kv, int group, int hd, int dtype, float scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_type<float>(q, k, v, n_valid, out, B, C, n_kv, group, hd, scale, s);
  if (dtype == 1)
    return launch_type<__nv_bfloat16>(q, k, v, n_valid, out, B, C, n_kv, group, hd,
                                      scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
