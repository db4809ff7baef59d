// Windowed EdgeConv-max aggregation for Hopper (sm_90a): forward and
// backward.
//
// FORWARD.  Replaces the Pallas TPU kernel
// deepmetv2_tpu/ops/pallas/edgeconv_window.py (_fwd_kernel, reached through
// window_max and window_edgeconv_linear_pallas).
// Computes, for c [B,N,H] f32 and pos [B,N,2] f32 (padded rows at 1e9):
//
//   m[b,i,h] = max { c[b,w,h] : w in [i-halo, i+halo] ∩ [0,N),
//                               de*de + dp*dp < r2 }        (-inf if none)
//
// with de = eta_i - eta_w, dp = phi_i - phi_w.  It matches the plain
// PyTorch version (ops/window.py:window_max_torch) bit for bit: the predicate
// rounds each operation on its own (window_adjacent, no FMA contraction),
// and a max selects one of its inputs exactly, in any order.
//
// Design.  One block takes ROWS consecutive query rows of one event; each
// of its warps takes ROWS/WARPS of them, with lane = feature h (h += 32 for
// H > 32).  The block walks its source window [t0-halo, t0+ROWS+halo) in
// chunks of 32 rows staged in shared memory (c rows are contiguous, so a
// chunk is one coalesced copy).  Per chunk and query, lane k tests source
// row k; __ballot_sync turns the chunk's adjacency into 32 bits, and the
// warp max-reduces c over the set bits only.  No atomics; every output is
// written once.
//
// What bounds it on the card: per launch it must move c and m once each plus
// the coordinates (21.6 MB at B=40, N=2048, H=32: 6.5 us at 3.35 TB/s), and
// the data needs one predicate per (real query, window row) pair plus one
// max per adjacent pair and feature (under 1 us of FP32 issue).  So the
// bound is bytes.  The kernel itself is issue-bound: on an H100 (700 W) it
// takes 0.33 ms there, and 82 % of that goes to padded query rows, which all
// sit at the same PAD_POS coordinate and so max-reduce over each other
// before the wrapper discards them (PERF.md).
// The TPU kernel's lane packing, supertile DMA and eta/phi chunk prune are
// TPU mechanics and are not carried over.
//
// PIPELINED FORWARD (window_max_fwd_pipelined).  Replaces the Pallas TPU
// kernel scripts/window_revolver_probe.py (_revolver_fwd_kernel, reached
// through _revolver_impl), the forward with its window copies
// double-buffered, written as a measurement probe.  The same function and
// design as the forward, with the 32-row chunks staged through two
// shared-memory buffers by cp.async: chunk k+1 is in flight while chunk k
// is reduced.  A max selects one of its inputs exactly and the chunks are
// taken in the same order, so it equals window_max_fwd and the plain
// version bit for bit.  It bounds like the forward (bytes); nothing on the
// main path calls it (deepmetv2_tpu_torch/probes/window_revolver.py times
// it against window_max_fwd).
//
// BACKWARD.  Replaces the Pallas TPU kernel _bwd_kernel of the same file
// (reached through _window_max_bwd, the custom VJP of window_max).
// Computes, for the forward's c and m, the gradient g of m, and pos:
//
//   dc[b,s,h] = sum over q in [s-halo, s+halo] ∩ [0,N) with adj(q,s) of
//               [c[b,s,h] == m[b,q,h]] * g[b,q,h]
//
// so every tied source gets the full gradient of its query (the TPU
// kernel's rule).  Where m is not finite it counts as +inf with g = 0 (the
// sentinels of _window_max_bwd).  Adjacency is recomputed from pos through
// the forward's window_adjacent, so forward and backward agree on every
// pair.  It matches ops/window.py:window_max_bwd_torch bit for bit: each
// source adds its terms in ascending query order, starting from 0.
//
// Design: the forward's shape with the roles swapped.  A block takes ROWS
// source rows, a warp ROWS/WARPS of them with lane = feature; the block
// walks the query window [t0-halo, t0+ROWS+halo) in 32-row chunks of m, g
// and coordinates staged in shared memory; a ballot gives the chunk's
// adjacency and the warp walks its set bits in ascending q.  No atomics;
// every output is written once.
//
// What bounds it on the card: it must read c, m, g and pos once and write
// dc once (8.5 MB at B=8, N=2048, H=32: 2.5 us at 3.35 TB/s); the data
// needs one predicate per (source, window query) pair plus a compare and an
// add per adjacent pair and feature.  So the bound is bytes; like the
// forward, the kernel itself is limited by instruction throughput (times
// in PERF.md).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int ROWS = 32;    // query rows per block
constexpr int WARPS = 8;    // warps per block
constexpr int CHUNK = 32;   // source rows staged per step (one per lane)

// The adjacency predicate, rounded one IEEE operation at a time so that it
// equals torch's eager de*de + dp*dp < r2 (and JAX's).  Symmetric in (q, s).
// The backward kernel uses the same function, so both directions agree on
// every pair, boundary pairs included.
__device__ __forceinline__ bool window_adjacent(float qe, float qp, float se,
                                                float sp, float r2) {
  const float de = __fsub_rn(qe, se);
  const float dp = __fsub_rn(qp, sp);
  return __fadd_rn(__fmul_rn(de, de), __fmul_rn(dp, dp)) < r2;
}

template <int NH>  // ceil(H / 32) features per lane
__global__ void __launch_bounds__(WARPS * 32)
window_max_fwd_kernel(const float* __restrict__ c,
                      const float* __restrict__ pos,
                      float* __restrict__ out, int N, int H, int halo,
                      float r2) {
  extern __shared__ float smem[];
  float* c_s = smem;                  // [CHUNK][H]
  float* e_s = smem + CHUNK * H;      // [CHUNK]
  float* p_s = e_s + CHUNK;           // [CHUNK]

  constexpr int QPW = ROWS / WARPS;   // query rows per warp
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* cb = c + static_cast<size_t>(b) * N * H;
  const float* pb = pos + static_cast<size_t>(b) * N * 2;

  float qe[QPW], qp[QPW], acc[QPW][NH];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = t0 + warp * QPW + j;
    qe[j] = q < N ? pb[2 * q] : 0.f;
    qp[j] = q < N ? pb[2 * q + 1] : 0.f;
#pragma unroll
    for (int t = 0; t < NH; ++t) acc[j][t] = -CUDART_INF_F;
  }

  const int lo = max(0, t0 - halo);
  const int hi = min(N, t0 + ROWS + halo);
  for (int s0 = lo; s0 < hi; s0 += CHUNK) {
    const int rows = min(CHUNK, hi - s0);
    __syncthreads();  // the previous chunk has been consumed
    const float* src = cb + static_cast<size_t>(s0) * H;
    for (int k = threadIdx.x; k < rows * H; k += WARPS * 32) c_s[k] = src[k];
    if (threadIdx.x < rows) {
      e_s[threadIdx.x] = pb[2 * (s0 + threadIdx.x)];
      p_s[threadIdx.x] = pb[2 * (s0 + threadIdx.x) + 1];
    }
    __syncthreads();

    const int s = s0 + lane;  // this lane's source row
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int q = t0 + warp * QPW + j;
      if (q >= N) break;  // warp-uniform
      const bool in = lane < rows && s >= q - halo && s <= q + halo;
      const bool adj =
          in && window_adjacent(qe[j], qp[j], e_s[lane], p_s[lane], r2);
      unsigned bits = __ballot_sync(0xffffffffu, adj);
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const float* row = c_s + k * H;
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          const int h = lane + 32 * t;
          if (h < H) acc[j][t] = fmaxf(acc[j][t], row[h]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = t0 + warp * QPW + j;
    if (q >= N) break;
    float* o = out + (static_cast<size_t>(b) * N + q) * H;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      if (h < H) o[h] = acc[j][t];
    }
  }
}

template <int NH>  // ceil(H / 32) features per lane
__global__ void __launch_bounds__(WARPS * 32)
window_max_bwd_kernel(const float* __restrict__ c,
                      const float* __restrict__ pos,
                      const float* __restrict__ m,
                      const float* __restrict__ g,
                      float* __restrict__ dc, int N, int H, int halo,
                      float r2) {
  extern __shared__ float smem[];
  float* m_s = smem;                  // [CHUNK][H]
  float* g_s = smem + CHUNK * H;      // [CHUNK][H]
  float* e_s = g_s + CHUNK * H;       // [CHUNK]
  float* p_s = e_s + CHUNK;           // [CHUNK]

  constexpr int SPW = ROWS / WARPS;   // source rows per warp
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(b) * N * H;
  const float* pb = pos + static_cast<size_t>(b) * N * 2;

  float se[SPW], sp[SPW], cv[SPW][NH], acc[SPW][NH];
#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    const int s = t0 + warp * SPW + j;
    se[j] = s < N ? pb[2 * s] : 0.f;
    sp[j] = s < N ? pb[2 * s + 1] : 0.f;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      cv[j][t] = (s < N && h < H) ? c[base + static_cast<size_t>(s) * H + h]
                                  : 0.f;
      acc[j][t] = 0.f;
    }
  }

  const int lo = max(0, t0 - halo);
  const int hi = min(N, t0 + ROWS + halo);
  for (int q0 = lo; q0 < hi; q0 += CHUNK) {
    const int rows = min(CHUNK, hi - q0);
    __syncthreads();  // the previous chunk has been consumed
    const size_t off = base + static_cast<size_t>(q0) * H;
    for (int k = threadIdx.x; k < rows * H; k += WARPS * 32) {
      const float mv = m[off + k];
      const bool fin = fabsf(mv) < CUDART_INF_F;  // false for inf and NaN
      m_s[k] = fin ? mv : CUDART_INF_F;
      g_s[k] = fin ? g[off + k] : 0.f;
    }
    if (threadIdx.x < rows) {
      e_s[threadIdx.x] = pb[2 * (q0 + threadIdx.x)];
      p_s[threadIdx.x] = pb[2 * (q0 + threadIdx.x) + 1];
    }
    __syncthreads();

    const int q = q0 + lane;  // this lane's query row
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int s = t0 + warp * SPW + j;
      if (s >= N) break;  // warp-uniform
      const bool in = lane < rows && q >= s - halo && q <= s + halo;
      const bool adj =
          in && window_adjacent(e_s[lane], p_s[lane], se[j], sp[j], r2);
      unsigned bits = __ballot_sync(0xffffffffu, adj);
      while (bits) {  // ascending q
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const float* mrow = m_s + k * H;
        const float* grow = g_s + k * H;
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          const int h = lane + 32 * t;
          if (h < H && cv[j][t] == mrow[h]) acc[j][t] += grow[h];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    const int s = t0 + warp * SPW + j;
    if (s >= N) break;
    float* o = dc + base + static_cast<size_t>(s) * H;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      if (h < H) o[h] = acc[j][t];
    }
  }
}

template <int NH>
cudaError_t launch(const float* c, const float* pos, float* out, int B, int N,
                   int H, int halo, float r2, cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const size_t smem = (static_cast<size_t>(CHUNK) * H + 2 * CHUNK) *
                      sizeof(float);
  window_max_fwd_kernel<NH><<<grid, WARPS * 32, smem, stream>>>(
      c, pos, out, N, H, halo, r2);
  return cudaGetLastError();
}

// The forward with its chunks double-buffered through cp.async (see the
// file's notes): stage k+1 is issued before chunk k is reduced.
template <int NH>  // ceil(H / 32) features per lane
__global__ void __launch_bounds__(WARPS * 32)
window_max_fwd_pipelined_kernel(const float* __restrict__ c,
                                const float* __restrict__ pos,
                                float* __restrict__ out, int N, int H,
                                int halo, float r2) {
  extern __shared__ float smem[];
  const int stage_floats = CHUNK * H + 2 * CHUNK;
  // buffer s: c rows [CHUNK][H], then eta [CHUNK], then phi [CHUNK]

  constexpr int QPW = ROWS / WARPS;   // query rows per warp
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* cb = c + static_cast<size_t>(b) * N * H;
  const float* pb = pos + static_cast<size_t>(b) * N * 2;

  float qe[QPW], qp[QPW], acc[QPW][NH];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = t0 + warp * QPW + j;
    qe[j] = q < N ? pb[2 * q] : 0.f;
    qp[j] = q < N ? pb[2 * q + 1] : 0.f;
#pragma unroll
    for (int t = 0; t < NH; ++t) acc[j][t] = -CUDART_INF_F;
  }

  const int lo = max(0, t0 - halo);
  const int hi = min(N, t0 + ROWS + halo);
  const int nch = (hi - lo + CHUNK - 1) / CHUNK;
  auto stage = [&](int k) {
    float* buf = smem + (k & 1) * stage_floats;
    const int s0 = lo + k * CHUNK;
    const int rows = min(CHUNK, hi - s0);
    const float* src = cb + static_cast<size_t>(s0) * H;
    for (int i = threadIdx.x; i < rows * H; i += WARPS * 32)
      __pipeline_memcpy_async(buf + i, src + i, sizeof(float));
    if (threadIdx.x < rows) {
      __pipeline_memcpy_async(buf + CHUNK * H + threadIdx.x,
                              pb + 2 * (s0 + threadIdx.x), sizeof(float));
      __pipeline_memcpy_async(buf + CHUNK * H + CHUNK + threadIdx.x,
                              pb + 2 * (s0 + threadIdx.x) + 1, sizeof(float));
    }
    __pipeline_commit();
  };

  if (nch > 0) stage(0);
  for (int k = 0; k < nch; ++k) {
    if (k + 1 < nch) {
      stage(k + 1);              // its buffer was freed by the last barrier
      __pipeline_wait_prior(1);  // chunk k has landed (this thread's part)
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();             // ... and every thread's part
    const float* c_s = smem + (k & 1) * stage_floats;
    const float* e_s = c_s + CHUNK * H;
    const float* p_s = e_s + CHUNK;
    const int s0 = lo + k * CHUNK;
    const int rows = min(CHUNK, hi - s0);
    const int s = s0 + lane;  // this lane's source row
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int q = t0 + warp * QPW + j;
      if (q >= N) break;  // warp-uniform
      const bool in = lane < rows && s >= q - halo && s <= q + halo;
      const bool adj =
          in && window_adjacent(qe[j], qp[j], e_s[lane], p_s[lane], r2);
      unsigned bits = __ballot_sync(0xffffffffu, adj);
      while (bits) {
        const int kk = __ffs(bits) - 1;
        bits &= bits - 1;
        const float* row = c_s + kk * H;
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          const int h = lane + 32 * t;
          if (h < H) acc[j][t] = fmaxf(acc[j][t], row[h]);
        }
      }
    }
    __syncthreads();             // chunk k's buffer may be refilled
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = t0 + warp * QPW + j;
    if (q >= N) break;
    float* o = out + (static_cast<size_t>(b) * N + q) * H;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      if (h < H) o[h] = acc[j][t];
    }
  }
}

template <int NH>
cudaError_t launch_pipelined(const float* c, const float* pos, float* out,
                             int B, int N, int H, int halo, float r2,
                             cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const size_t smem = 2 * (static_cast<size_t>(CHUNK) * H + 2 * CHUNK) *
                      sizeof(float);
  window_max_fwd_pipelined_kernel<NH><<<grid, WARPS * 32, smem, stream>>>(
      c, pos, out, N, H, halo, r2);
  return cudaGetLastError();
}

template <int NH>
cudaError_t launch_bwd(const float* c, const float* pos, const float* m,
                       const float* g, float* dc, int B, int N, int H,
                       int halo, float r2, cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const size_t smem = (2 * static_cast<size_t>(CHUNK) * H + 2 * CHUNK) *
                      sizeof(float);
  window_max_bwd_kernel<NH><<<grid, WARPS * 32, smem, stream>>>(
      c, pos, m, g, dc, N, H, halo, r2);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the launch's cudaError_t.
extern "C" int window_max_fwd(const float* c, const float* pos, float* out,
                              int B, int N, int H, int halo, float r2,
                              cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  switch ((H + 31) / 32) {
    case 1: return launch<1>(c, pos, out, B, N, H, halo, r2, stream);
    case 2: return launch<2>(c, pos, out, B, N, H, halo, r2, stream);
    case 3: return launch<3>(c, pos, out, B, N, H, halo, r2, stream);
    case 4: return launch<4>(c, pos, out, B, N, H, halo, r2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C interface of the pipelined forward; the same contract as window_max_fwd.
extern "C" int window_max_fwd_pipelined(const float* c, const float* pos,
                                        float* out, int B, int N, int H,
                                        int halo, float r2,
                                        cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  switch ((H + 31) / 32) {
    case 1: return launch_pipelined<1>(c, pos, out, B, N, H, halo, r2, stream);
    case 2: return launch_pipelined<2>(c, pos, out, B, N, H, halo, r2, stream);
    case 3: return launch_pipelined<3>(c, pos, out, B, N, H, halo, r2, stream);
    case 4: return launch_pipelined<4>(c, pos, out, B, N, H, halo, r2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C interface of the backward; the same contract as window_max_fwd.
extern "C" int window_max_bwd(const float* c, const float* pos, const float* m,
                              const float* g, float* dc, int B, int N, int H,
                              int halo, float r2, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  switch ((H + 31) / 32) {
    case 1: return launch_bwd<1>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    case 2: return launch_bwd<2>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    case 3: return launch_bwd<3>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    case 4: return launch_bwd<4>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
