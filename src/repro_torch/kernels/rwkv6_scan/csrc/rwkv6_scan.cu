// WKV-6 (RWKV "Finch", data-dependent decay), for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/rwkv6_scan/rwkv6_scan.py:78  wkv6_chunked_pallas
// and computes its function: per (batch, head), over a 64 x 64 fp32
// state S,
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T
// from S_0 = s0, returning y and S_final. Held to the PyTorch twin in
// ../ref.py.
//
// Bound: HBM bytes. r, k, v, log_w and y move 20 bytes per (b, t, h, i)
// and the state 2 x 16 KB per (b, h); the arithmetic is ~5 fp32
// operations per state element and step, about 4 per byte moved, under
// the card's ~20 fp32 operations per byte.
//
// Design (simple and right first): the step recurrence, not the TPU's
// chunked form. The TPU kernel builds three C x C x 64 contractions per
// chunk from pairwise log-space decay ratios, to feed its matrix unit and
// to keep e^{cum} * e^{-cum} from overflowing at strong decay. Here:
//   * One block of 64 threads per (batch, head); thread j holds column j
//     of S in 64 registers for the whole sequence, so the state leaves
//     HBM once and returns once.
//   * Inputs stay in the model layout (B, S, H, 64): at each step thread
//     j loads element j of r_t, k_t, v_t, log_w_t (256-byte coalesced
//     rows), one step ahead of its use.
//   * Per step, (r_i, k_i, w_i = exp(log_w_i), u_i k_i) are staged in a
//     double-buffered shared array (one barrier per step; every thread
//     reads each entry as a broadcast), then thread j forms
//     y_j = sum_i r_i (S_ij + u_i k_i v_j) over four partial sums and
//     updates S_ij = w_i S_ij + k_i v_j.
//   * At strong decay (log_w down to -e^10) exp gives 0: nothing to
//     overflow. The same code serves decode (S = 1) and prefill.
// A chunked tensor-core form (the TPU kernel's) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kHead = 64;  // head size: threads per block, state is kHead^2

// grid (B * H), block kHead threads.
__global__ void __launch_bounds__(kHead)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  __shared__ float4 stage[2][kHead];  // (r_i, k_i, w_i, u_i k_i) of a step

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j = threadIdx.x;

  float st[kHead];  // st[i] = S[i][j]
  const float* s_in = s0 + static_cast<size_t>(bh) * kHead * kHead + j;
#pragma unroll
  for (int i = 0; i < kHead; ++i) st[i] = s_in[i * kHead];
  const float uj = u[h * kHead + j];

  const size_t stride = static_cast<size_t>(H) * kHead;  // one time step
  const size_t base = static_cast<size_t>(b) * S * stride + h * kHead + j;
  float rn = r[base], kn = k[base], vn = v[base], wn = log_w[base];
  for (int t = 0; t < S; ++t) {
    const float rt = rn, kt = kn, vt = vn, lwt = wn;
    if (t + 1 < S) {  // the next step's inputs, in flight during this one
      const size_t nxt = base + static_cast<size_t>(t + 1) * stride;
      rn = r[nxt];
      kn = k[nxt];
      vn = v[nxt];
      wn = log_w[nxt];
    }
    float4* buf = stage[t & 1];
    buf[j] = make_float4(rt, kt, expf(lwt), uj * kt);
    __syncthreads();  // also orders this step's writes after step t-1's reads
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kHead; ++i) {
      const float4 c = buf[i];
      acc[i & 3] = fmaf(c.x, fmaf(c.w, vt, st[i]), acc[i & 3]);
      st[i] = fmaf(c.z, st[i], c.y * vt);
    }
    y[base + static_cast<size_t>(t) * stride] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }

  float* so = s_out + static_cast<size_t>(bh) * kHead * kHead + j;
#pragma unroll
  for (int i = 0; i < kHead; ++i) so[i * kHead] = st[i];
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v, log_w, y (B, S, H, 64); u (H, 64); s0, s_out (B, H, 64, 64);
// all fp32, contiguous; S >= 1. Launches on `stream`, returns
// cudaGetLastError().
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* log_w, const float* u, const float* s0, float* y,
                float* s_out, int B, int S, int H, void* stream) {
  wkv6_kernel<<<B * H, kHead, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, log_w, u, s0, y, s_out, S, H);
  return cudaGetLastError();
}

}  // extern "C"
