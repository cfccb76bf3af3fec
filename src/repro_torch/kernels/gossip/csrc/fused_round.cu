// The gossip stage for Hopper (sm_90a): one launch is one compressed
// gossip round of a buffer (core/compression.py) -- int8 difference-coded
// quantization with error feedback (top-k masked when topk > 0) + the W
// mix, with no local update. (The round megakernels, which add the local
// update, are in fused_round_cluster.cu.)
//
// Replaces the TPU kernel
//   src/repro/kernels/gossip/gossip.py:378  gossip_mix_pallas  (stage + mix)
// and is held bit for bit (recon', res', scales) and within fp32
// summation order (mixed) to the PyTorch twin in ../ref.py.
//
// Bound: HBM bytes. The stage reads 3 and writes 3 (n, t) fp32 buffers
// (plus the (n, t/chunk) scales and the n x n weights). The n x n
// contraction is 2 n^2 t flops, well under the fp32 peak for the node
// counts the engine runs. At the main-path size (n = 20, t = 1536: about
// 0.74 MB moved, on 3 blocks) the kernel is launch-bound, not
// bandwidth-bound.
//
// Design (simple and right first):
//   * One block owns one (n, chunk) column chunk with ALL n rows: the
//     per-(row, chunk) scale needs the whole row of the chunk, and the mix
//     needs every row of a column. Blocks share nothing and run in any
//     order (the TPU grid's sequential order is not relied on).
//   * One warp per row runs the stage of quantize.cuh: the payload into a
//     shared tile, the row's max |payload| by shuffles, the top-k
//     threshold by a ballot search over the bits of |payload| (the TOPK
//     instantiations), then quantizes the row in place and leaves recon'
//     (or, with stale_mix, the input recon) in the tile.
//   * The mix reads the tile and W_off from shared memory; each thread
//     accumulates 4 rows of one column, and reads its self term x again
//     from global memory.
//   * Shared memory holds the n x chunk tile (dynamic shared memory; the
//     wrapper refuses tiles over 227 KB).
//   * Rounding matches the twin exactly (see quantize.cuh).

#include "quantize.cuh"

namespace {

using namespace gossip;

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;

// Copy W_off (zero-padded to n_pad rows) and w_self into shared memory.
__device__ void load_weights(const float* __restrict__ w_off,
                             const float* __restrict__ w_self, float* woff_s,
                             float* wself_s, const Geometry& geo) {
  for (int k = threadIdx.x; k < geo.n_pad * geo.n; k += blockDim.x) {
    woff_s[k] = k < geo.n * geo.n ? w_off[k] : 0.f;
  }
  for (int i = threadIdx.x; i < geo.n_pad; i += blockDim.x) {
    wself_s[i] = i < geo.n ? w_self[i] : 0.f;
  }
}

// The stage over this block's column chunk: payload, scale, (top-k,)
// quantize, recon'/res' out, then mixed = W_off @ nbr + w_self * src.
template <bool EF, bool DC, bool STALE, bool TOPK, class Src>
__device__ void wire(const Src& src, const float* __restrict__ recon,
                     const float* __restrict__ res, float* __restrict__ mixed,
                     float* __restrict__ new_recon, float* __restrict__ new_res,
                     float* __restrict__ scales, const float* woff_s,
                     const float* wself_s, float* tile, const Geometry& geo) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const int chunk = geo.chunk;
  const int ci = blockIdx.x;
  const size_t c0 = static_cast<size_t>(ci) * chunk;

  for (int i = warp; i < geo.n; i += n_warps) {
    const size_t row = static_cast<size_t>(i) * geo.t + c0;
    float* trow = tile + static_cast<size_t>(i) * chunk;
    const float m = payload_row<EF, DC>(src, recon, res, row, chunk, trow,
                                        nullptr);
    const RowScale rs = row_scale<TOPK>(m, trow, chunk, geo.topk);
    if (lane == 0) scales[static_cast<size_t>(i) * geo.n_chunks + ci] = rs.scale;
    // leave the mix's neighbor view in the tile: recon' (or, with
    // stale_mix, the input recon)
    quantize_row<EF, DC, TOPK>(trow, rs, recon, res, new_recon, new_res, row,
                               chunk,
                               [&](int c, float, float nr) {
                                 trow[c] = STALE ? recon[row + c] : nr;
                               });
  }
  __syncthreads();

  const int groups = geo.n_pad / kRowsPerThread;
  for (int idx = threadIdx.x; idx < groups * chunk; idx += blockDim.x) {
    const int c = idx % chunk;
    const int i0 = (idx / chunk) * kRowsPerThread;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int j = 0; j < geo.n; ++j) {
      const float v = tile[static_cast<size_t>(j) * chunk + c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc[r] = fmaf(woff_s[(i0 + r) * geo.n + j], v, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = i0 + r;
      if (i < geo.n) {
        const size_t o = static_cast<size_t>(i) * geo.t + c0 + c;
        mixed[o] = __fadd_rn(acc[r], __fmul_rn(wself_s[i], src(o)));
      }
    }
  }
  __syncthreads();  // the next wire reuses the tile
}

// The gossip stage's source: x itself, with no local update. It is both
// the payload's source and the mix's self term (mixed = W_off @ recon' +
// w_self * x, the exact x).
struct Load {
  const float* __restrict__ x;
  __device__ float operator()(size_t o) const { return x[o]; }
};

template <bool EF, bool DC, bool STALE, bool TOPK>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const float* __restrict__ x, const float* __restrict__ recon,
                  const float* __restrict__ res,
                  const float* __restrict__ w_off,
                  const float* __restrict__ w_self, float* __restrict__ mixed,
                  float* __restrict__ new_recon, float* __restrict__ new_res,
                  float* __restrict__ scales, Geometry geo) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* woff_s = tile + static_cast<size_t>(geo.n) * geo.chunk;
  float* wself_s = woff_s + geo.n_pad * geo.n;
  load_weights(w_off, w_self, woff_s, wself_s, geo);
  __syncthreads();
  wire<EF, DC, STALE, TOPK>(Load{x}, recon, res, mixed, new_recon, new_res,
                            scales, woff_s, wself_s, tile, geo);
}

Geometry make_geometry(int n, int t, int chunk, int topk) {
  const int n_pad = (n + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  return Geometry{n, t, chunk, n_pad, t / chunk, topk};
}

size_t smem_bytes(const Geometry& geo) {
  return sizeof(float) * (static_cast<size_t>(geo.n) * geo.chunk +
                          static_cast<size_t>(geo.n_pad) * geo.n + geo.n_pad);
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const Geometry& geo, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_bytes(geo);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<geo.n_chunks, kThreads, smem, stream>>>(args..., geo);
  return cudaGetLastError();
}

// The 16 flag combinations of one kernel template, indexed
// ef<<3|dc<<2|stale<<1|topk.
#define FLAG_ROW(K, EF, DC) \
  K<EF, DC, false, false>, K<EF, DC, false, true>, K<EF, DC, true, false>, \
      K<EF, DC, true, true>
#define FLAG_TABLE(K)                                                   \
  { FLAG_ROW(K, false, false), FLAG_ROW(K, false, true),                \
    FLAG_ROW(K, true, false), FLAG_ROW(K, true, true) }

int flag_index(int ef, int dc, int stale, int topk) {
  return (ef ? 8 : 0) | (dc ? 4 : 0) | (stale ? 2 : 0) | (topk > 0 ? 1 : 0);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (what the wrapper checks against
// the 227 KB per-block limit before launching): one n x chunk tile and
// the weights.
size_t gossip_mix_smem_bytes(int n, int chunk) {
  return smem_bytes(make_geometry(n, chunk, chunk, 0));
}

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream` and returns cudaGetLastError().
// topk: columns kept per (row, chunk) by the top-k mask, 0 for all.
int gossip_mix_launch(const float* x, const float* recon, const float* res,
                      const float* w_off, const float* w_self, float* mixed,
                      float* new_recon, float* new_res, float* scales, int n,
                      int t, int chunk, int topk, int ef, int dc, int stale,
                      void* stream) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      const float*, float*, float*, float*, float*, Geometry);
  static const Fn table[16] = FLAG_TABLE(gossip_mix_kernel);
  return launch(table[flag_index(ef, dc, stale, topk)],
                make_geometry(n, t, chunk, topk),
                static_cast<cudaStream_t>(stream), x, recon, res, w_off,
                w_self, mixed, new_recon, new_res, scales);
}

}  // extern "C"
