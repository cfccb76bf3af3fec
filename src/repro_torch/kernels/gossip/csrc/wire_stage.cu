// Wire-stage kernels for Hopper (sm_90a): the fused round without its
// mix -- local update + int8 difference-coded quantization with error
// feedback (top-k masked when topk > 0) -- emitting the int8 payload and
// fp32 scales that go on the wire. The fused engine's bounded-staleness
// round mixes afterwards, in PyTorch, against a k-round-stale
// reconstruction.
//
// Replaces the TPU kernels
//   src/repro/kernels/gossip/gossip.py:631  wire_stage_pallas     (DSGD)
//   src/repro/kernels/gossip/gossip.py:679  wire_stage_gt_pallas  (DSGT)
// and is held bit for bit (h, t_half, q, scales, recon', res') to the
// PyTorch twins in ../ref.py.
//
// Bound: HBM bytes. DSGD reads 4 fp32 (n, t) buffers and writes 3 fp32 +
// 1 int8 (n, t) buffers and the (n, t/chunk) scales, 29 B per element;
// DSGT reads 8 and writes 6 fp32 + 2 int8, 58 B per element. About 13
// fp32 operations per element and wire (more with top-k: 31 compare
// passes of the threshold search), far under the fp32 peak per byte.
//
// Design (simple and right first): there is no W, so rows are
// independent and one warp owns one (row, chunk) -- the stage of
// quantize.cuh, with the chunk in a per-warp shared-memory row buffer.
// A block holds up to 8 warps (fewer for chunks over 1,536 columns, so a
// block stays within 48 KB of shared memory), so unlike the round kernels
// there is no tile limit in n. Loads are coalesced: a warp reads 32
// consecutive columns per step. DSGT runs the tracker wire, then the
// parameter wire (which recomputes t_half from global memory), through
// the same row buffer.

#include "quantize.cuh"

namespace {

using namespace gossip;

constexpr int kMaxWarps = 8;
constexpr int kSmemBudget = 48 * 1024;

int warps_per_block(int chunk) {
  const int w = kSmemBudget / (4 * chunk);
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
}

size_t smem_bytes(int chunk) {
  return sizeof(float) * static_cast<size_t>(warps_per_block(chunk)) * chunk;
}

// The outputs of one wire.
struct WireOut {
  int8_t* q;
  float* scales;
  float* new_recon;
  float* new_res;
};

// The stage on one (row i, chunk ci) of one wire; src to h_out.
template <bool EF, bool DC, bool TOPK, class Src>
__device__ void stage(const Src& src, const float* __restrict__ recon,
                      const float* __restrict__ res, float* __restrict__ h_out,
                      const WireOut& out, int i, int ci, float* trow,
                      const Geometry& geo) {
  const size_t row =
      static_cast<size_t>(i) * geo.t + static_cast<size_t>(ci) * geo.chunk;
  const float m =
      payload_row<EF, DC>(src, recon, res, row, geo.chunk, trow, h_out);
  const RowScale rs = row_scale<TOPK>(m, trow, geo.chunk, geo.topk);
  if (threadIdx.x % 32 == 0) {
    out.scales[static_cast<size_t>(i) * geo.n_chunks + ci] = rs.scale;
  }
  int8_t* q_out = out.q;
  quantize_row<EF, DC, TOPK>(
      trow, rs, recon, res, out.new_recon, out.new_res, row, geo.chunk,
      [&](int c, float q, float) {
        // q is an integer in [-127, 127]: the cast is exact
        q_out[row + c] = static_cast<int8_t>(__float2int_rn(q));
      });
}

// This warp's (row, chunk), or false past the end (the whole warp leaves:
// the kernels have no block-wide barrier).
__device__ bool warp_pair(const Geometry& geo, int* i, int* ci) {
  const int warps = blockDim.x / 32;
  const size_t pair =
      static_cast<size_t>(blockIdx.x) * warps + threadIdx.x / 32;
  if (pair >= static_cast<size_t>(geo.n) * geo.n_chunks) return false;
  *i = static_cast<int>(pair / geo.n_chunks);
  *ci = static_cast<int>(pair % geo.n_chunks);
  return true;
}

template <bool EF, bool DC, bool TOPK>
__global__ void __launch_bounds__(kMaxWarps * 32)
wire_stage_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ recon,
                  const float* __restrict__ res, float alpha,
                  float* __restrict__ h, WireOut out, Geometry geo) {
  extern __shared__ float smem[];
  int i, ci;
  if (!warp_pair(geo, &i, &ci)) return;
  float* trow = smem + static_cast<size_t>(threadIdx.x / 32) * geo.chunk;
  stage<EF, DC, TOPK>(Update{x, g, alpha}, recon, res, h, out, i, ci, trow,
                      geo);
}

template <bool EF, bool DC, bool TOPK>
__global__ void __launch_bounds__(kMaxWarps * 32)
wire_stage_gt_kernel(const float* __restrict__ x, const float* __restrict__ t,
                     const float* __restrict__ g, const float* __restrict__ gp,
                     const float* __restrict__ recon_x,
                     const float* __restrict__ res_x,
                     const float* __restrict__ recon_t,
                     const float* __restrict__ res_t, float alpha,
                     float* __restrict__ h, float* __restrict__ t_half,
                     WireOut out_x, WireOut out_t, Geometry geo) {
  extern __shared__ float smem[];
  int i, ci;
  if (!warp_pair(geo, &i, &ci)) return;
  float* trow = smem + static_cast<size_t>(threadIdx.x / 32) * geo.chunk;
  const TrackerHalf th{t, g, gp};
  stage<EF, DC, TOPK>(th, recon_t, res_t, t_half, out_t, i, ci, trow, geo);
  stage<EF, DC, TOPK>(TrackedUpdate{x, th, alpha}, recon_x, res_x, h, out_x, i,
                      ci, trow, geo);
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const Geometry& geo, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_bytes(geo.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int warps = warps_per_block(geo.chunk);
  const size_t pairs = static_cast<size_t>(geo.n) * geo.n_chunks;
  const unsigned blocks = static_cast<unsigned>((pairs + warps - 1) / warps);
  kernel<<<blocks, warps * 32, smem, stream>>>(args..., geo);
  return cudaGetLastError();
}

// The 8 flag combinations of one kernel template, indexed ef<<2|dc<<1|topk.
#define FLAG_TABLE(K)                                                     \
  { K<false, false, false>, K<false, false, true>, K<false, true, false>, \
    K<false, true, true>,   K<true, false, false>, K<true, false, true>,  \
    K<true, true, false>,   K<true, true, true> }

int flag_index(int ef, int dc, int topk) {
  return (ef ? 4 : 0) | (dc ? 2 : 0) | (topk > 0 ? 1 : 0);
}

Geometry make_geometry(int n, int t, int chunk, int topk) {
  return Geometry{n, t, chunk, n, t / chunk, topk};
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (what the wrapper checks against
// the 227 KB per-block limit before launching).
size_t wire_stage_smem_bytes(int chunk) { return smem_bytes(chunk); }

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream` and returns cudaGetLastError().
// topk: columns kept per (row, chunk) by the top-k mask, 0 for all.
int wire_stage_launch(const float* x, const float* g, const float* recon,
                      const float* res, float alpha, float* h, int8_t* q,
                      float* scales, float* new_recon, float* new_res, int n,
                      int t, int chunk, int topk, int ef, int dc,
                      void* stream) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      float, float*, WireOut, Geometry);
  static const Fn table[8] = FLAG_TABLE(wire_stage_kernel);
  return launch(table[flag_index(ef, dc, topk)],
                make_geometry(n, t, chunk, topk),
                static_cast<cudaStream_t>(stream), x, g, recon, res, alpha, h,
                WireOut{q, scales, new_recon, new_res});
}

int wire_stage_gt_launch(const float* x, const float* t, const float* g,
                         const float* gp, const float* recon_x,
                         const float* res_x, const float* recon_t,
                         const float* res_t, float alpha, float* h,
                         float* t_half, int8_t* q_x, float* scales_x,
                         float* new_recon_x, float* new_res_x, int8_t* q_t,
                         float* scales_t, float* new_recon_t, float* new_res_t,
                         int n, int tot, int chunk, int topk, int ef, int dc,
                         void* stream) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      const float*, const float*, const float*, const float*,
                      float, float*, float*, WireOut, WireOut, Geometry);
  static const Fn table[8] = FLAG_TABLE(wire_stage_gt_kernel);
  return launch(table[flag_index(ef, dc, topk)],
                make_geometry(n, tot, chunk, topk),
                static_cast<cudaStream_t>(stream), x, t, g, gp, recon_x, res_x,
                recon_t, res_t, alpha, h, t_half,
                WireOut{q_x, scales_x, new_recon_x, new_res_x},
                WireOut{q_t, scales_t, new_recon_t, new_res_t});
}

}  // extern "C"
