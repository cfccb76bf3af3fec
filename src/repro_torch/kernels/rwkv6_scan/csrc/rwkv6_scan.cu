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
// Bound: HBM bytes on paper, instruction issue in practice. r, k, v,
// log_w and y move 20 bytes per (b, t, h, i) and the state 2 x 16 KB per
// (b, h): 806 us at B 8, H 64, S 4096 on an H100. The step recurrence
// costs 3 fp32 instructions per state element and step (below), some
// 0.8 ms of the card's fp32 issue at that shape, so the two bounds are
// close and the kernel has to keep the FMA pipes fed. Shared memory hands
// each lane 4 bytes a clock, so a thread that read r_i, k_i and w_i for
// every state element it updates would wait on shared memory three times
// as long as it computes; and a step's work must not wait on a barrier or
// a long dependent chain.
//
// Design: the step recurrence, not the TPU's chunked form. The TPU kernel
// builds three C x C x 64 contractions per chunk from pairwise log-space
// decay ratios to feed its matrix unit; at the model's decay clip (log_w
// = -e^10) those ratios lose precision (its kernel departs from its own
// step oracle by up to 2.0 there), while exp(-e^10) = 0 is exact here.
//   * Columns of S are independent (column j needs only v_j); only y_j
//     sums over rows. A thread holds an 8 x 8 block of S in registers: 8
//     rows of 8 columns, so each r_i, k_i, w_i it reads feeds 8 columns
//     and each v_j 8 rows. A column is split over 8 adjacent lanes of 8
//     rows each; a warp holds 32 columns, a block of two warps one (b, h).
//     The dependent chain a step is 8 long, and y comes from a 3-round
//     butterfly over the 8 lanes (7 shuffles leave each lane one column's
//     sum). (Four columns a thread, four warps a head: more warps, but
//     slower on an H100.)
//   * The bonus term factors, y_j = sum_i r_i S_ij + (sum_i r_i u_i k_i)
//     v_j, so a state element costs r_i * S_ij (FMA), k_i * v_j and the
//     update S_ij = fmaf(w_i, S_ij, k_i v_j): 3 instructions a step. The
//     update's arithmetic is the earlier kernel's, so S_final agrees with
//     the twin as before; y is summed in another order.
//   * Inputs arrive in chunks of kChunk = 16 steps: the head's r, k, log_w
//     and v rows (1 KB a step), through 16-byte cp.async copies into a
//     2-stage ring in shared memory (a decode step stages one row). A
//     chunk is in flight while the previous one computes, and two barriers
//     a chunk replace the earlier kernel's barrier a step. Within a step
//     row the copies place the 16-byte run of rows 8q + 4m .. 8q + 4m + 3
//     at run 8m + q, so the eight lanes of a column read one contiguous
//     128 bytes.
//   * Once a chunk has landed the block prepares it: exp(log_w) in place
//     (16 independent exps a thread, all in flight) and the bonus dots (a
//     step a 4-thread group, 16 products each, two shuffles). Done a step
//     at a time by one warp, this preparation was the largest stall on an
//     H100.
//   * y leaves straight from the lanes that summed it: a warp's 32 lanes
//     hold its 32 columns, one whole 128-byte line a step.
//   * The state enters and leaves through shared memory (swizzled, so a
//     thread's 8 x 8 block is read and written without bank conflicts) in
//     512-byte coalesced runs a warp. Read straight into the 8 x 8 blocks,
//     a warp's accesses cover 64 bytes of each of 8 rows, and decode (S =
//     1), which is little but the state's 16 KB in and out, ran slower so
//     on an H100. The state is copied after chunk 0 and u, so
//     chunk 0 is prepared while it arrives.
// The same code serves decode and prefill; any S >= 1 (a short last chunk
// is handled in the kernel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHead = 64;                          // head size: the state is kHead^2
constexpr int kSlices = 8;                         // lanes a column is split over
constexpr int kRows = kHead / kSlices;             // 8 rows a thread
constexpr int kCols = 8;                           // 8 columns a thread
constexpr int kThreads = kHead / kCols * kSlices;  // 64: a warp per 32 columns
constexpr int kChunk = 16;                         // steps staged at a time
constexpr int kRuns = kHead / 4;                   // 16-byte runs in a row
static_assert(kThreads == 4 * kChunk, "a chunk's bonus dots take 4 threads a step");

// Shared memory of a launch whose chunks hold `rows` = min(S, kChunk)
// steps. A stage is r, k, w and v (rows x 64 each) and the bonus dots
// (rows, padded to a run). Region A holds the state on its way in and out
// (64 x 64) and, when S > kChunk, the odd chunks' stage; region B holds the
// even chunks' stage; then u (64, in a staged row's order).
__host__ __device__ constexpr int stage_floats(int rows) {
  return 4 * rows * kHead + (rows + 3) / 4 * 4;
}
__host__ __device__ constexpr int region_a_floats(int S) {
  return S > kChunk && stage_floats(kChunk) > kHead * kHead ? stage_floats(kChunk)
                                                             : kHead * kHead;
}
__host__ __device__ constexpr size_t smem_bytes(int S) {
  return sizeof(float) * (region_a_floats(S) + stage_floats(S < kChunk ? S : kChunk) + kHead);
}

// Run c of a staged row (rows 4c .. 4c + 3) sits at run 8 (c % 2) + c / 2.
__device__ __forceinline__ int to_slot(int c) { return 8 * (c % 2) + c / 2; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// In region A, state row p keeps its 16-byte run c at run c ^ (p / 8 % 8),
// so a thread's 8 x 8 block (rows 8q .., runs c0 / 4 and c0 / 4 + 4) is
// read and written without bank conflicts.
__device__ __forceinline__ int state_at(int p, int c) { return p * kHead + 4 * (c ^ (p / 8 % 8)); }

// grid (B * H), block kThreads, dynamic shared memory smem_bytes(S).
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  extern __shared__ __align__(16) float smem[];
  const int rows = min(S, kChunk);
  float* const region_a = smem;
  float* const region_b = smem + region_a_floats(S);
  float* const us = region_b + stage_floats(rows);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int q = lane % kSlices;  // rows kRows * q ..
  // A warp holds 32 columns; this lane's slot j is column c0 + 16 (j / 4)
  // + j % 4 (runs c0 / 4 and c0 / 4 + 4), so a row's 16-byte accesses by
  // the warp's four column groups cover 64 contiguous bytes.
  const int c0 = 32 * (tid / 32) + 4 * (lane / kSlices);
  const int col = c0 + 16 * (q / 4) + q % 4;  // slot q: the column whose y this lane sums

  const size_t stride = static_cast<size_t>(H) * kHead;  // one time step
  const size_t head = static_cast<size_t>(b) * S * stride + static_cast<size_t>(h) * kHead;
  const float* const s_in = s0 + static_cast<size_t>(bh) * kHead * kHead;
  float* const s_fin = s_out + static_cast<size_t>(bh) * kHead * kHead;

  // Chunk c's stage: r, k, w, v, bonus at 0, 1, 2, 3, 4 x rows x 64.
  auto stage = [&](int c) { return c % 2 ? region_a : region_b; };
  // Copy steps [t0, t0 + n) into chunk c's stage: 16 runs each of r, k,
  // log_w and v a step, 16 copies a thread for a full chunk.
  auto issue = [&](int c, int t0, int n) {
    float* const rs = stage(c);
#pragma unroll 1
    for (int idx = tid; idx < n * kRuns; idx += kThreads) {
      const int step = idx / kRuns;
      const int run = idx % kRuns;
      const size_t src = head + static_cast<size_t>(t0 + step) * stride + 4 * run;
      const int dst = step * kHead + 4 * to_slot(run);
      cp_async16(rs + dst, r + src);
      cp_async16(rs + rows * kHead + dst, k + src);
      cp_async16(rs + 2 * rows * kHead + dst, log_w + src);
      cp_async16(rs + 3 * rows * kHead + step * kHead + 4 * run, v + src);
    }
  };

  // Chunk 0 and u (in a staged row's order), then the state (512-byte
  // coalesced runs a warp): two groups, so that chunk 0 is prepared while
  // the state is still arriving.
  issue(0, 0, rows);
  if (tid < kRuns) cp_async16(us + 4 * to_slot(tid), u + h * kHead + 4 * tid);
  cp_async_commit();
#pragma unroll 4
  for (int idx = tid; idx < kHead * kRuns; idx += kThreads)
    cp_async16(region_a + state_at(idx / kRuns, idx % kRuns), s_in + 4 * idx);
  cp_async_commit();

  // st[x][j] = S[kRows * q + x][c0 + 16 (j / 4) + j % 4]
  float st[kRows][kCols];
  for (int c = 0, t0 = 0; t0 < S; ++c, t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    float* const rs = stage(c);
    const float* const ks = rs + rows * kHead;
    float* const ws = rs + 2 * rows * kHead;
    const float* const vs = rs + 3 * rows * kHead;
    float* const bonus = rs + 4 * rows * kHead;
    if (c == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk c visible; every thread is done with chunk c - 1
    // prepare chunk c: the decays (16 a thread, independent, all in
    // flight at once) and the bonus dots (a step a 4-thread group)
#pragma unroll
    for (int i = 0; i < kChunk * kHead / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < n * kHead) ws[idx] = expf(ws[idx]);
    }
    {  // a step's 64 products over 4 adjacent threads, 16 row positions each
      const int step = tid / 4;
      const int part = tid % 4;
      float d = 0.f;
      if (step < n) {
#pragma unroll
        for (int e = 0; e < kHead / 16; ++e) {
          const int at = kHead / 4 * part + 4 * e;
          const float4 r4 = ld4(rs + step * kHead + at), k4 = ld4(ks + step * kHead + at);
          const float4 u4 = ld4(us + at);
          d = fmaf(r4.x, u4.x * k4.x, d);
          d = fmaf(r4.y, u4.y * k4.y, d);
          d = fmaf(r4.z, u4.z * k4.z, d);
          d = fmaf(r4.w, u4.w * k4.w, d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (part == 0 && step < n) bonus[step] = d;
    }
    if (c == 0) cp_async_wait<0>();  // the state
    __syncthreads();  // chunk c prepared (and at c = 0 the state landed)
    if (c == 0) {
#pragma unroll
      for (int x = 0; x < kRows; ++x) {
        const int p = kRows * q + x;
#pragma unroll
        for (int hh = 0; hh < kCols / 4; ++hh) {
          const float4 a = ld4(region_a + state_at(p, c0 / 4 + 4 * hh));
          st[x][4 * hh] = a.x; st[x][4 * hh + 1] = a.y;
          st[x][4 * hh + 2] = a.z; st[x][4 * hh + 3] = a.w;
        }
      }
      // a thread stashes its state back where it read it; chunk 1 lands
      // in region A only once every thread has read its state
      if (S > kChunk) __syncthreads();
    }
    if (t0 + kChunk < S) {
      issue(c + 1, t0 + kChunk, min(kChunk, S - t0 - kChunk));
      cp_async_commit();
    }

#pragma unroll 4
    for (int step = 0; step < n; ++step) {
      const int at = step * kHead;
      const float bv = bonus[step], vc = vs[at + col];  // for y, loaded early
      float vv[kCols];
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 a = ld4(vs + at + c0 + 16 * hh);
        vv[4 * hh] = a.x; vv[4 * hh + 1] = a.y; vv[4 * hh + 2] = a.z; vv[4 * hh + 3] = a.w;
      }
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const int run = at + 4 * (8 * m + q);
        const float4 r4 = ld4(rs + run), k4 = ld4(ks + run), w4 = ld4(ws + run);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            float& s = st[4 * m + e][j];
            acc[j] = fmaf(rr[e], s, acc[j]);
            s = fmaf(ww[e], s, kk[e] * vv[j]);
          }
        }
      }
      // butterfly over the 8 lanes of the column group: lane q ends with
      // the sum of its slot q (global column `col`)
#pragma unroll
      for (int half = kCols / 2; half > 0; half /= 2) {
        const bool upper = q & half;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = upper ? acc[j] : acc[j + half];
          const float keep = upper ? acc[j + half] : acc[j];
          acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, half);
        }
      }
      // a warp's 32 lanes hold its 32 columns: one whole 128-byte line
      y[head + static_cast<size_t>(t0 + step) * stride + col] = fmaf(bv, vc, acc[0]);
    }
  }

  // The state leaves through region A, free once the last chunk is
  // computed (at once when there was one chunk: its stage is region B,
  // and a thread writes where it read).
  if (S > kChunk) __syncthreads();
#pragma unroll
  for (int x = 0; x < kRows; ++x) {
    const int p = kRows * q + x;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
      *reinterpret_cast<float4*>(region_a + state_at(p, c0 / 4 + 4 * hh)) =
          make_float4(st[x][4 * hh], st[x][4 * hh + 1], st[x][4 * hh + 2], st[x][4 * hh + 3]);
  }
  __syncthreads();
#pragma unroll 4
  for (int idx = tid; idx < kHead * kRuns; idx += kThreads)
    *reinterpret_cast<float4*>(s_fin + 4 * idx) = ld4(region_a + state_at(idx / kRuns, idx % kRuns));
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v, log_w, y (B, S, H, 64); u (H, 64); s0, s_out (B, H, 64, 64);
// all fp32, contiguous and 16-byte aligned; S >= 1.
// Launches on `stream`, returns cudaGetLastError().
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* log_w, const float* u, const float* s0, float* y,
                float* s_out, int B, int S, int H, void* stream) {
  const size_t smem = smem_bytes(S);
  wkv6_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, log_w, u, s0, y, s_out, S, H);
  return cudaGetLastError();
}

}  // extern "C"
