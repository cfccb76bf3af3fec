// Prefill (full-sequence) attention in float32 with an online softmax,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:113  flash_attention_bhsd
// for float32 inputs (bfloat16 inputs, what serving runs, go to the
// tensor-core kernel in flash_attention_tc.cu) and computes its function:
// causal and/or sliding-window self-attention
// (q and k positions both counted from 0; key j is live for query i when
// j <= i and j > i - window), GQA with un-repeated K/V (q-head h reads
// kv-head h / (H / K)), fp32 scores, softmax and accumulation with scale
// hd^-0.5; a row with no live key gives zeros. Held to the PyTorch twin
// in ../ref.py within 1e-5: every product and sum is fp32, which is why
// this path stays off the bf16 tensor cores.
//
// Bound: operations (4 hd flops per live (query, key) pair against 2 hd
// x 4 bytes of K/V per key); for fp32 on the CUDA cores, 67 TFLOP/s.
//
// Design (simple and right first):
//   * Inputs stay in the model layout: q (B, Sq, H, hd), k/v (B, Sk, K,
//     hd); no repeated or transposed copy of K/V is made.
//   * One block per (q tile of 64 rows, batch x q-head); 4 threads per
//     query row, each owning hd/4 of its dims (float4 chunks interleaved
//     so the 4 threads hit distinct shared-memory banks), with the row's
//     q, fp32 acc, m and l in registers.
//   * The block walks the K/V tiles of 64 keys that can hold a live key
//     -- tiles wholly above the causal diagonal or left of the window
//     are skipped, as the TPU kernel skips them -- staging each tile in
//     shared memory (zero past Sk, so a masked p never meets garbage).
//     The masks are template flags. Scores are reduced over the 4 threads
//     by shuffles; each thread keeps every 4th score of the tile for the
//     max, the sum and exp, and P·V broadcasts them back by shuffles.
//   * Rows past Sq (a tail tile) compute nothing that is written.
//   * At hd 256 the K/V tiles take 128 KB of shared memory (one block per
//     SM) and each thread keeps 64 floats of q and 64 of acc; ptxas's
//     register and spill counts for it are in the build's .log.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowThreads = 4;  // threads per query row
constexpr int kThreads = kBlockQ * kRowThreads;
constexpr unsigned kFull = 0xffffffffu;

size_t smem_bytes(int hd) { return 2 * sizeof(float) * kBlockK * hd; }

// grid (ceil(Sq / kBlockQ), B * H); block kThreads; dynamic shared
// memory: the K and V tiles, kBlockK x HD fp32 each.
template <int HD, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Sq,
                           int Sk, int H, int n_kv, int window, float scale) {
  constexpr int NC = HD / 16;                   // float4 chunks per thread
  constexpr int NS = kBlockK / kRowThreads;     // scores kept per thread
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBlockK][HD]
  float* v_s = k_s + kBlockK * HD;               // [kBlockK][HD]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / n_kv);
  const int q_lo = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  const int lane = threadIdx.x & 31;
  const int qpos = q_lo + row;
  const bool q_live = qpos < Sq;

  // this thread's dims: d(c, e) = c * 16 + sub * 4 + e
  float qr[NC][4], acc[NC][4];
  const float* q_row = q + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c][e] = q_live ? q_row[c * 16 + sub * 4 + e] : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = -CUDART_INF_F, l = 0.f;

  const size_t kv_row = static_cast<size_t>(n_kv) * HD;
  const float* k_b = k + static_cast<size_t>(b) * Sk * kv_row + kvh * HD;
  const float* v_b = v + static_cast<size_t>(b) * Sk * kv_row + kvh * HD;

  // the K/V tiles that can hold a live key for some row of this q tile
  const int q_hi = min(q_lo + kBlockQ, Sq) - 1;
  const int n_kt = (Sk + kBlockK - 1) / kBlockK;
  int kt_begin = 0, kt_end = n_kt;
  if (CAUSAL) kt_end = min(n_kt, q_hi / kBlockK + 1);
  if (WINDOW) kt_begin = max(0, q_lo - window + 1) / kBlockK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBlockK;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * HD; i += kThreads) {
      const int j = i / HD;
      const int d = i % HD;
      const bool ok = k_lo + j < Sk;
      const size_t off = static_cast<size_t>(k_lo + j) * kv_row + d;
      k_s[i] = ok ? k_b[off] : 0.f;
      v_s[i] = ok ? v_b[off] : 0.f;
    }
    __syncthreads();

    // scores: thread `sub` keeps keys j with j % 4 == sub
    float s_reg[NS];
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * HD) + sub;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[c * 4];
        part += qr[c][0] * kk.x + qr[c][1] * kk.y + qr[c][2] * kk.z + qr[c][3] * kk.w;
      }
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      const int kpos = k_lo + j;
      bool live = q_live && kpos < Sk;
      if (CAUSAL) live = live && kpos <= qpos;
      if (WINDOW) live = live && kpos > qpos - window;
      if ((j & 3) == sub) s_reg[j >> 2] = live ? part * scale : -CUDART_INF_F;
    }

    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < NS; ++r) tmax = fmaxf(tmax, s_reg[r]);
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // a row with no live key yet keeps m = -inf; guard the exp arguments
    const float safe_m = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float corr = m == -CUDART_INF_F ? 0.f : expf(m - safe_m);
    float p_reg[NS];
    float psum = 0.f;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      p_reg[r] = s_reg[r] == -CUDART_INF_F ? 0.f : expf(s_reg[r] - safe_m);
      psum += p_reg[r];
    }
    psum += __shfl_xor_sync(kFull, psum, 1);
    psum += __shfl_xor_sync(kFull, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
    }

#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = __shfl_sync(kFull, p_reg[j >> 2], (lane & ~3) | (j & 3));
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * HD) + sub;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[c * 4];
        acc[c][0] += pj * vv.x;
        acc[c][1] += pj * vv.y;
        acc[c][2] += pj * vv.z;
        acc[c][3] += pj * vv.w;
      }
    }
  }

  if (q_live) {
    const float denom = l > 0.f ? l : 1.f;
    float* o_row = out + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_row[c * 16 + sub * 4 + e] = acc[c][e] / denom;
      }
    }
  }
}

template <int HD, bool CAUSAL, bool WINDOW>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int n_kv, int window,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<HD, CAUSAL, WINDOW>;
  const size_t smem = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, n_kv, window,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_flags(const void* q, const void* k, const void* v, void* out,
                         int B, int Sq, int Sk, int H, int n_kv, int causal,
                         int window, float scale, cudaStream_t stream) {
  if (causal && window > 0)
    return launch_one<HD, true, true>(q, k, v, out, B, Sq, Sk, H, n_kv, window, scale, stream);
  if (causal)
    return launch_one<HD, true, false>(q, k, v, out, B, Sq, Sk, H, n_kv, 0, scale, stream);
  if (window > 0)
    return launch_one<HD, false, true>(q, k, v, out, B, Sq, Sk, H, n_kv, window, scale, stream);
  return launch_one<HD, false, false>(q, k, v, out, B, Sq, Sk, H, n_kv, 0, scale, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block takes at head size hd.
size_t flash_attention_smem_bytes(int hd) { return smem_bytes(hd); }

// q (B, Sq, H, hd), k/v (B, Sk, n_kv, hd), out (B, Sq, H, hd), all
// float32, contiguous; H a multiple of n_kv; hd 64, 128 or 256; window 0
// for none. Launches on `stream`, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported hd).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int n_kv,
                           int hd, int causal, int window, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_flags<64>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, s);
  if (hd == 128)
    return launch_flags<128>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, s);
  if (hd == 256)
    return launch_flags<256>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
