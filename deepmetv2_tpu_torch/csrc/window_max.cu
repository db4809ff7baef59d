// Windowed EdgeConv-max aggregation for Hopper (sm_90a): forward and
// backward.
//
// FORWARD.  Replaces the Pallas TPU kernel
// deepmetv2_tpu/ops/pallas/edgeconv_window.py (_fwd_kernel, reached through
// window_max and window_edgeconv_linear_pallas).
// Computes, for c [B,N,H] f32 and pos [B,N,2] f32:
//
//   m[b,i,h] = max { c[b,w,h] : w in [i-halo, i+halo] ∩ [0,N), w real,
//                               de*de + dp*dp < r2 }        (-inf if none)
//
// for a real row i, and -inf for a padded one, with de = eta_i - eta_w,
// dp = phi_i - phi_w.  PADDED ROWS: a row is padded when its eta is at least
// PAD_POS / 2 (PAD_HALF below; the wrapper puts padded rows at PAD_POS =
// 1e9, and ops/window.py:padded_rows is the same test).  A padded query row
// gets -inf and a padded source is never selected.  It matches the plain
// PyTorch version (ops/window.py:window_max_torch with mask = the real rows)
// bit for bit: the predicate rounds each operation on its own
// (window_adjacent, no FMA contraction), and a max selects one of its
// inputs exactly, in any order.
//
// Design.  One block takes ROWS consecutive query rows of one event; each
// of its warps takes ROWS/WARPS of them, with lane = feature h (h += 32 for
// H > 32).
//  1. Every warp reads the block's 32 query coordinates (one coalesced
//     256-byte load).  A block whose rows are all padded writes its -inf
//     rows and returns: it visits nothing.
//  2. plan_window stages the coordinates of the whole source window
//     [t0-halo, t0+ROWS+halo) ∩ [0,N) into shared memory in one coalesced
//     pass, reduces each 32-row chunk's box (the ranges of eta and phi over
//     its real rows) with warp shuffles, and lists the chunks whose box is
//     not apart from the query rows' box (boxes_apart; the TPU kernel's
//     eta/phi chunk prune, _chunk_bounds, with ops/window.py:
//     window_chunks_needed as its oracle).  Across a gap d with d*d >= r2
//     no pair is adjacent, since rounding is monotone, so the prune drops
//     no adjacent pair and changes no bit.
//  3. Only the kept chunks' c rows are staged, double-buffered through
//     cp.async (16-byte copies when H % 4 == 0): chunk k+1 is in flight
//     while chunk k is reduced.  Per chunk and real query, lane k tests
//     source row k; __ballot_sync turns the chunk's adjacency into 32 bits,
//     and the warp max-reduces c over the set bits only, two rows per step
//     (two independent shared-memory loads; a max is exact in any order).
//     A warp skips its padded query rows.  No atomics; every output is
//     written once.
//
// What bounds it on the card: per launch it must move c and m once each plus
// the coordinates (21.6 MB at B=40, N=2048, H=32: 6.5 us at 3.35 TB/s), and
// the data needs one predicate per (real query, window row) pair plus one
// max per adjacent pair and feature (under 1 us of FP32 issue).  So the
// bound is bytes.  Most of a batch's rows are padding, all at one
// coordinate and so adjacent to each other, and most of a cell-ordered
// window lies in other phi cells: the design visits neither padded rows
// nor pruned chunks, and what is left is a short latency chain per block
// (times and their breakdown in PERF.md).  No tensor cores: the body holds
// no product (the GEMMs around it stay torch.matmul, as the JAX package
// leaves them to XLA).
//
// PIPELINED FORWARD (window_max_fwd_pipelined).  Replaces the Pallas TPU
// kernel scripts/window_revolver_probe.py (_revolver_fwd_kernel, reached
// through _revolver_impl), the forward with its window copies
// double-buffered, written as a measurement probe.  It stages every 32-row
// chunk of the window (no prune, no early exit) through two shared-memory
// buffers by cp.async, chunk k+1 in flight while chunk k is reduced, with
// the padded-row rule above (a padded query row stays -inf, a padded source
// is never selected).  So it computes the same function and equals
// window_max_fwd and the plain version bit for bit.  It bounds like the
// forward (bytes); nothing on the main path calls it
// (deepmetv2_tpu_torch/probes/window_revolver.py times it against
// window_max_fwd).
//
// BFLOAT16 VALUES (window_max_fwd_bf16, window_max_bwd_bf16).  Replace the
// same two Pallas kernels where they carry bf16 values
// (window_edgeconv_linear_pallas(dtype=bfloat16), ModelConfig.compute_dtype):
// c, m, g and dc are bf16 while pos and the predicate stay f32.  The forward
// and the backward are templates on the value type T (float or
// __nv_bfloat16), instantiated for both.  A bf16 value is compared and summed
// as the float __bfloat162float gives, which is exact and injective, so a max
// selects the same input and the tie test c == m holds for the same pairs as
// in bf16; the forward writes the selected value back (__float2bfloat16_rn of
// a bf16 value is that value), and the backward sums in f32 from 0 in
// ascending query order and rounds once (__float2bfloat16_rn), as the plain
// version (window_max_bwd_torch: float32 sums, one cast at the end) and the
// TPU kernel's f32 accumulator do.  Staging: 16-byte cp.async copies when a
// row is a whole number of 16 bytes (H % 8 == 0 in bf16) and the base is
// aligned; else 4-byte cp.async in f32 and a plain copy in bf16 (cp.async has
// no 2-byte size).  The bound is the f32 kernels' with half the value bytes.
//
// BACKWARD.  Replaces the Pallas TPU kernel _bwd_kernel of the same file
// (reached through _window_max_bwd, the custom VJP of window_max).
// Computes, for the forward's c and m, the gradient g of m, and pos:
//
//   dc[b,s,h] = sum over real q in [s-halo, s+halo] ∩ [0,N) with adj(q,s)
//               of [c[b,s,h] == m[b,q,h]] * g[b,q,h]
//
// for a real source s, and 0 for a padded one, whatever m and g hold; a
// padded query contributes nothing.  So every tied source gets the full
// gradient of its query (the TPU kernel's rule).  Where m is not finite it
// counts as +inf with g = 0 (the sentinels of _window_max_bwd).  Adjacency
// is recomputed from pos through the forward's window_adjacent, so forward
// and backward agree on every pair.  It matches
// ops/window.py:window_max_bwd_torch bit for bit: each source adds its
// terms in ascending query order, starting from 0.
//
// Design: the forward's with the roles swapped.  A block takes ROWS source
// rows, a warp ROWS/WARPS of them with lane = feature.  A block whose
// sources are all padded writes zeros.  plan_window prunes the query chunks
// by the same box test (adjacency is symmetric, as on the TPU), and only
// the kept chunks' m and g rows are staged, double-buffered through
// cp.async; a ballot gives the chunk's adjacency and the warp walks its set
// bits in ascending q, loading two queries' m per step and adding their
// terms in order.  Warps split by source rows, never by chunks, so each
// source's sum keeps its order.  No atomics; every output is written once.
//
// What bounds it on the card: it must read c, m, g and pos once and write
// dc once (8.5 MB at B=8, N=2048, H=32: 2.5 us at 3.35 TB/s); the data
// needs one predicate per (source, window query) pair plus a compare and an
// add per adjacent pair and feature.  So the bound is bytes (times in
// PERF.md).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int ROWS = 32;    // query (forward) or source (backward) rows
constexpr int WARPS = 8;    // warps per block
constexpr int CHUNK = 32;   // source rows staged per step (one per lane)
constexpr unsigned FULL = 0xffffffffu;
constexpr float PAD_HALF = 5e8f;   // PAD_POS / 2: an eta >= it marks padding

__device__ __forceinline__ bool is_padded(float eta) {
  return eta >= PAD_HALF;
}

// The values' type T (float or __nv_bfloat16) to float and back, through the
// intrinsics only; both directions are exact for a value that T holds.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// The backward's sentinels (_window_max_bwd): where m is not finite it
// counts as +inf, with a gradient of 0.
__device__ __forceinline__ float finite_or_inf(float mv) {
  return fabsf(mv) < CUDART_INF_F ? mv : CUDART_INF_F;  // false for inf, NaN
}

__device__ __forceinline__ float grad_of(float mv, float gv) {
  return fabsf(mv) < CUDART_INF_F ? gv : 0.f;
}

// The ranges of eta and phi over a set of rows (+inf..-inf when empty).
struct Box {
  float elo, ehi, plo, phi;
};

// The box of the warp's real rows (each lane holds one row).
__device__ __forceinline__ Box warp_box(bool real, float e, float p) {
  Box b{real ? e : CUDART_INF_F, real ? e : -CUDART_INF_F,
        real ? p : CUDART_INF_F, real ? p : -CUDART_INF_F};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b.elo = fminf(b.elo, __shfl_xor_sync(FULL, b.elo, o));
    b.ehi = fmaxf(b.ehi, __shfl_xor_sync(FULL, b.ehi, o));
    b.plo = fminf(b.plo, __shfl_xor_sync(FULL, b.plo, o));
    b.phi = fmaxf(b.phi, __shfl_xor_sync(FULL, b.phi, o));
  }
  return b;
}

// True when the gap from hi_near up to lo_far is at least the radius: no
// pair across it is adjacent (rounding is monotone, and adding the other
// axis' square, >= 0, cannot round the sum below this one).
__device__ __forceinline__ bool far_apart(float lo_far, float hi_near,
                                          float r2) {
  const float d = __fsub_rn(lo_far, hi_near);
  return d > 0.f && __fmul_rn(d, d) >= r2;
}

// The prune: two non-empty boxes that are apart on either axis hold no
// adjacent pair.  Symmetric, so it serves both kernels.
__device__ __forceinline__ bool boxes_apart(const Box& a, const Box& b,
                                            float r2) {
  return far_apart(b.elo, a.ehi, r2) || far_apart(a.elo, b.ehi, r2) ||
         far_apart(b.plo, a.phi, r2) || far_apart(a.plo, b.phi, r2);
}

// The block's own rows [t0, t0+ROWS): this lane's row coordinates (row
// t0 + lane) and, as bits, which of the 32 rows are real.  Every warp reads
// the same 256 bytes and gets the same answer.
__device__ __forceinline__ unsigned block_rows(const float* pb, int t0, int N,
                                               float& e, float& p) {
  const int r = t0 + static_cast<int>(threadIdx.x & 31);
  e = 0.f;
  p = 0.f;
  bool real = false;
  if (r < N) {
    const float2 v = reinterpret_cast<const float2*>(pb)[r];
    e = v.x;
    p = v.y;
    real = !is_padded(e);
  }
  return __ballot_sync(FULL, real);
}

// Stages the coordinates of the window [lo, hi) into e_w/p_w, and lists in
// `list`, ascending, the 32-row chunks of the window (chunk k: rows
// lo + 32k ..) that hold a real row and whose box is not apart from
// `rows_box`; returns their count.  Ends with a barrier.  Called by the
// whole block.
__device__ int plan_window(const float* pb, int lo, int hi,
                           const Box& rows_box, float r2, float* e_w,
                           float* p_w, int* keep, int* list, int* count) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int W = hi - lo;
  const int nch = (W + CHUNK - 1) / CHUNK;
  const float2* p2 = reinterpret_cast<const float2*>(pb) + lo;
  for (int i = threadIdx.x; i < W; i += WARPS * 32) {
    const float2 v = p2[i];
    e_w[i] = v.x;
    p_w[i] = v.y;
  }
  __syncthreads();
  for (int k = warp; k < nch; k += WARPS) {
    const int i = k * CHUNK + lane;
    const float e = i < W ? e_w[i] : 0.f;
    const float p = i < W ? p_w[i] : 0.f;
    const bool real = i < W && !is_padded(e);
    const unsigned any = __ballot_sync(FULL, real);
    const Box b = warp_box(real, e, p);
    if (lane == 0) keep[k] = any != 0u && !boxes_apart(rows_box, b, r2);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < nch; k0 += 32) {
      const bool kept = k0 + lane < nch && keep[k0 + lane];
      const unsigned bits = __ballot_sync(FULL, kept);
      if (kept) list[n + __popc(bits & ((1u << lane) - 1u))] = k0 + lane;
      n += __popc(bits);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// Issues (does not commit) the copies of `rows` rows of H values of T from
// src to dst: cp.async of 16 bytes each when `vec` (vec16 below), else of one
// value each for a 4-byte T; a 2-byte T has no cp.async size of its own, so
// it is copied by plain loads and stores (visible after the caller's
// barrier).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           int H, bool vec) {
  if (vec) {
    const int n16 = rows * H * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < n16; i += WARPS * 32)
      __pipeline_memcpy_async(reinterpret_cast<float4*>(dst) + i,
                              reinterpret_cast<const float4*>(src) + i,
                              sizeof(float4));
  } else if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < rows * H; i += WARPS * 32)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  } else {
    for (int i = threadIdx.x; i < rows * H; i += WARPS * 32) dst[i] = src[i];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 16-byte staging: a row of H values of T is a whole number of 16 bytes
// (so is every row offset) and the tensor's base is aligned.
template <typename T>
__device__ __forceinline__ bool vec16(int H, const T* base) {
  return (H * sizeof(T)) % 16 == 0 && aligned16(base);
}

// Shared memory after the staged rows: the window's coordinates [wmax] x 2,
// then keep, list [nchunks(wmax)] and the kept count.
__host__ __device__ inline int n_chunks(int wmax) {
  return (wmax + CHUNK - 1) / CHUNK;
}

__host__ __device__ inline size_t plan_bytes(int wmax) {
  return (2 * static_cast<size_t>(wmax) + 2 * n_chunks(wmax) + 1) *
         sizeof(float);
}

template <typename T, int NH>  // value type; ceil(H / 32) features per lane
__global__ void __launch_bounds__(WARPS * 32)
window_max_fwd_kernel(const T* __restrict__ c,
                      const float* __restrict__ pos,
                      T* __restrict__ out, int N, int H, int halo,
                      float r2, int wmax) {
  extern __shared__ float4 smem4[];
  T* c_s = reinterpret_cast<T*>(smem4);            // [2][CHUNK][H]
  float* e_w = reinterpret_cast<float*>(c_s + 2 * CHUNK * H);   // [wmax]
  float* p_w = e_w + wmax;                         // [wmax]
  int* keep = reinterpret_cast<int*>(p_w + wmax);  // [n_chunks(wmax)]
  int* list = keep + n_chunks(wmax);               // [n_chunks(wmax)]
  int* count = list + n_chunks(wmax);

  constexpr int QPW = ROWS / WARPS;   // query rows per warp
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* cb = c + static_cast<size_t>(b) * N * H;
  const float* pb = pos + static_cast<size_t>(b) * N * 2;
  T* ob = out + static_cast<size_t>(b) * N * H;

  float e, p;
  const unsigned real = block_rows(pb, t0, N, e, p);
  if (real == 0u) {   // every query row padded: -inf rows, nothing to visit
    const int n = min(ROWS, N - t0) * H;
    for (int k = threadIdx.x; k < n; k += WARPS * 32)
      ob[static_cast<size_t>(t0) * H + k] = from_float<T>(-CUDART_INF_F);
    return;
  }
  const Box rows_box = warp_box((real >> lane) & 1u, e, p);
  const unsigned mine = (real >> (warp * QPW)) & ((1u << QPW) - 1u);
  float qe[QPW], qp[QPW], acc[QPW][NH];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    qe[j] = __shfl_sync(FULL, e, warp * QPW + j);
    qp[j] = __shfl_sync(FULL, p, warp * QPW + j);
#pragma unroll
    for (int t = 0; t < NH; ++t) acc[j][t] = -CUDART_INF_F;
  }

  const int lo = max(0, t0 - halo);
  const int hi = min(N, t0 + ROWS + halo);
  const int nk =
      plan_window(pb, lo, hi, rows_box, r2, e_w, p_w, keep, list, count);
  const bool vec = vec16(H, c);
  auto stage = [&](int i) {   // kept chunk i into buffer i & 1
    const int s0 = lo + list[i] * CHUNK;
    stage_rows(c_s + (i & 1) * CHUNK * H, cb + static_cast<size_t>(s0) * H,
               min(CHUNK, hi - s0), H, vec);
    __pipeline_commit();
  };

  if (nk > 0) stage(0);
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) {
      stage(i + 1);              // its buffer was freed by the last barrier
      __pipeline_wait_prior(1);  // chunk i has landed (this thread's part)
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();             // ... and every thread's part
    const T* cs = c_s + (i & 1) * CHUNK * H;
    const int w0 = list[i] * CHUNK;   // the chunk's first row in the window
    const int rows = min(CHUNK, hi - lo - w0);
    const int s = lo + w0 + lane;     // this lane's source row
    const float se = lane < rows ? e_w[w0 + lane] : 0.f;
    const float sp = lane < rows ? p_w[w0 + lane] : 0.f;
    const bool src = lane < rows && !is_padded(se);
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      if (!((mine >> j) & 1u)) continue;   // padded query row (warp-uniform)
      const int q = t0 + warp * QPW + j;
      const bool adj = src && s >= q - halo && s <= q + halo &&
                       window_adjacent(qe[j], qp[j], se, sp, r2);
      unsigned bits = __ballot_sync(FULL, adj);
      while (bits) {   // two sources per step (the last one twice if odd)
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const int k2 = bits ? __ffs(bits) - 1 : k;
        bits &= bits - 1;
        const T* row = cs + k * H;
        const T* row2 = cs + k2 * H;
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          const int h = lane + 32 * t;
          if (h < H)
            acc[j][t] = fmaxf(acc[j][t],
                              fmaxf(to_float(row[h]), to_float(row2[h])));
        }
      }
    }
    __syncthreads();             // chunk i's buffer may be refilled
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = t0 + warp * QPW + j;
    if (q >= N) break;
    T* o = ob + static_cast<size_t>(q) * H;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      if (h < H) o[h] = from_float<T>(acc[j][t]);
    }
  }
}

template <typename T, int NH>  // value type; ceil(H / 32) features per lane
__global__ void __launch_bounds__(WARPS * 32)
window_max_bwd_kernel(const T* __restrict__ c,
                      const float* __restrict__ pos,
                      const T* __restrict__ m,
                      const T* __restrict__ g,
                      T* __restrict__ dc, int N, int H, int halo,
                      float r2, int wmax) {
  extern __shared__ float4 smem4[];
  T* m_s = reinterpret_cast<T*>(smem4);            // [2][CHUNK][H]
  T* g_s = m_s + 2 * CHUNK * H;                    // [2][CHUNK][H]
  float* e_w = reinterpret_cast<float*>(g_s + 2 * CHUNK * H);   // [wmax]
  float* p_w = e_w + wmax;                         // [wmax]
  int* keep = reinterpret_cast<int*>(p_w + wmax);  // [n_chunks(wmax)]
  int* list = keep + n_chunks(wmax);               // [n_chunks(wmax)]
  int* count = list + n_chunks(wmax);

  constexpr int SPW = ROWS / WARPS;   // source rows per warp
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(b) * N * H;
  const float* pb = pos + static_cast<size_t>(b) * N * 2;

  float e, p;
  const unsigned real = block_rows(pb, t0, N, e, p);
  if (real == 0u) {   // every source padded: zero rows, nothing to visit
    const int n = min(ROWS, N - t0) * H;
    for (int k = threadIdx.x; k < n; k += WARPS * 32)
      dc[base + static_cast<size_t>(t0) * H + k] = from_float<T>(0.f);
    return;
  }
  const Box rows_box = warp_box((real >> lane) & 1u, e, p);
  const unsigned mine = (real >> (warp * SPW)) & ((1u << SPW) - 1u);
  float se[SPW], sp[SPW], cv[SPW][NH], acc[SPW][NH];
#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    const int s = t0 + warp * SPW + j;
    se[j] = __shfl_sync(FULL, e, warp * SPW + j);
    sp[j] = __shfl_sync(FULL, p, warp * SPW + j);
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      cv[j][t] = ((mine >> j) & 1u) && h < H
                     ? to_float(c[base + static_cast<size_t>(s) * H + h])
                     : 0.f;
      acc[j][t] = 0.f;
    }
  }

  const int lo = max(0, t0 - halo);
  const int hi = min(N, t0 + ROWS + halo);
  const int nk =
      plan_window(pb, lo, hi, rows_box, r2, e_w, p_w, keep, list, count);
  const bool vec = vec16(H, m) && vec16(H, g);
  auto stage = [&](int i) {   // kept chunk i into buffer i & 1
    const int q0 = lo + list[i] * CHUNK;
    const int rows = min(CHUNK, hi - q0);
    const size_t off = base + static_cast<size_t>(q0) * H;
    stage_rows(m_s + (i & 1) * CHUNK * H, m + off, rows, H, vec);
    stage_rows(g_s + (i & 1) * CHUNK * H, g + off, rows, H, vec);
    __pipeline_commit();
  };

  if (nk > 0) stage(0);
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) {
      stage(i + 1);              // its buffer was freed by the last barrier
      __pipeline_wait_prior(1);  // chunk i has landed (this thread's part)
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();             // ... and every thread's part
    const T* ms = m_s + (i & 1) * CHUNK * H;
    const T* gs = g_s + (i & 1) * CHUNK * H;
    const int w0 = list[i] * CHUNK;   // the chunk's first row in the window
    const int rows = min(CHUNK, hi - lo - w0);
    const int q = lo + w0 + lane;     // this lane's query row
    const float qe = lane < rows ? e_w[w0 + lane] : 0.f;
    const float qp = lane < rows ? p_w[w0 + lane] : 0.f;
    const bool qry = lane < rows && !is_padded(qe);
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      if (!((mine >> j) & 1u)) continue;   // padded source row (warp-uniform)
      const int s = t0 + warp * SPW + j;
      const bool adj = qry && q >= s - halo && q <= s + halo &&
                       window_adjacent(qe, qp, se[j], sp[j], r2);
      unsigned bits = __ballot_sync(FULL, adj);
      while (bits) {   // ascending q, two queries per step
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const int k2 = bits ? __ffs(bits) - 1 : -1;
        bits &= bits - 1;
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          const int h = lane + 32 * t;
          if (h < H) {
            const float mv = to_float(ms[k * H + h]);
            const float mv2 = k2 >= 0 ? to_float(ms[k2 * H + h]) : 0.f;
            if (cv[j][t] == finite_or_inf(mv))
              acc[j][t] += grad_of(mv, to_float(gs[k * H + h]));
            if (k2 >= 0 && cv[j][t] == finite_or_inf(mv2))
              acc[j][t] += grad_of(mv2, to_float(gs[k2 * H + h]));
          }
        }
      }
    }
    __syncthreads();             // chunk i's buffers may be refilled
  }

#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    const int s = t0 + warp * SPW + j;
    if (s >= N) break;
    T* o = dc + base + static_cast<size_t>(s) * H;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int h = lane + 32 * t;
      if (h < H) o[h] = from_float<T>(acc[j][t]);
    }
  }
}

// Sets the kernel's dynamic shared-memory limit where it needs more than
// the default 48 KB, then launches it.
template <typename Kernel, typename... Args>
cudaError_t launch_with(Kernel kernel, dim3 grid, size_t smem,
                        cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, WARPS * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int NH>
cudaError_t launch(const T* c, const float* pos, T* out, int B, int N, int H,
                   int halo, float r2, cudaStream_t stream) {
  const int wmax = std::min(N, ROWS + 2 * halo);
  const size_t smem =
      2 * static_cast<size_t>(CHUNK) * H * sizeof(T) + plan_bytes(wmax);
  return launch_with(window_max_fwd_kernel<T, NH>,
                     dim3((N + ROWS - 1) / ROWS, B), smem, stream, c, pos, out,
                     N, H, halo, r2, wmax);
}

// The forward for either value type; the C entry points' contract.
template <typename T>
int window_max_fwd_t(const T* c, const float* pos, T* out, int B, int N,
                     int H, int halo, float r2, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  if (halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  halo = std::min(halo, N);
  switch ((H + 31) / 32) {
    case 1: return launch<T, 1>(c, pos, out, B, N, H, halo, r2, stream);
    case 2: return launch<T, 2>(c, pos, out, B, N, H, halo, r2, stream);
    case 3: return launch<T, 3>(c, pos, out, B, N, H, halo, r2, stream);
    case 4: return launch<T, 4>(c, pos, out, B, N, H, halo, r2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pipelined probe's forward (see the file's notes): every chunk of the
// window, stage k+1 issued before chunk k is reduced.
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
  bool qr[QPW];   // a real query row
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = t0 + warp * QPW + j;
    qe[j] = q < N ? pb[2 * q] : 0.f;
    qp[j] = q < N ? pb[2 * q + 1] : 0.f;
    qr[j] = q < N && !is_padded(qe[j]);
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
    const bool src = lane < rows && !is_padded(e_s[lane]);
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      if (!qr[j]) continue;  // padded query row (warp-uniform)
      const int q = t0 + warp * QPW + j;
      const bool adj = src && s >= q - halo && s <= q + halo &&
                       window_adjacent(qe[j], qp[j], e_s[lane], p_s[lane], r2);
      unsigned bits = __ballot_sync(FULL, adj);
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
  const size_t smem = 2 * (static_cast<size_t>(CHUNK) * H + 2 * CHUNK) *
                      sizeof(float);
  return launch_with(window_max_fwd_pipelined_kernel<NH>,
                     dim3((N + ROWS - 1) / ROWS, B), smem, stream, c, pos,
                     out, N, H, halo, r2);
}

template <typename T, int NH>
cudaError_t launch_bwd(const T* c, const float* pos, const T* m, const T* g,
                       T* dc, int B, int N, int H, int halo, float r2,
                       cudaStream_t stream) {
  const int wmax = std::min(N, ROWS + 2 * halo);
  const size_t smem =
      4 * static_cast<size_t>(CHUNK) * H * sizeof(T) + plan_bytes(wmax);
  return launch_with(window_max_bwd_kernel<T, NH>,
                     dim3((N + ROWS - 1) / ROWS, B), smem, stream, c, pos, m,
                     g, dc, N, H, halo, r2, wmax);
}

// The backward for either value type; the C entry points' contract.
template <typename T>
int window_max_bwd_t(const T* c, const float* pos, const T* m, const T* g,
                     T* dc, int B, int N, int H, int halo, float r2,
                     cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  if (halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  halo = std::min(halo, N);
  switch ((H + 31) / 32) {
    case 1:
      return launch_bwd<T, 1>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    case 2:
      return launch_bwd<T, 2>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    case 3:
      return launch_bwd<T, 3>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    case 4:
      return launch_bwd<T, 4>(c, pos, m, g, dc, B, N, H, halo, r2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the launch's cudaError_t.  The
// window reaches halo rows each way (halo >= 0; a halo above N is taken as
// N).
extern "C" int window_max_fwd(const float* c, const float* pos, float* out,
                              int B, int N, int H, int halo, float r2,
                              cudaStream_t stream) {
  return window_max_fwd_t(c, pos, out, B, N, H, halo, r2, stream);
}

// C interface of the forward on bf16 values (c, out bf16; pos f32); the same
// contract as window_max_fwd.
extern "C" int window_max_fwd_bf16(const __nv_bfloat16* c, const float* pos,
                                   __nv_bfloat16* out, int B, int N, int H,
                                   int halo, float r2, cudaStream_t stream) {
  return window_max_fwd_t(c, pos, out, B, N, H, halo, r2, stream);
}

// C interface of the pipelined forward; the same contract as window_max_fwd.
extern "C" int window_max_fwd_pipelined(const float* c, const float* pos,
                                        float* out, int B, int N, int H,
                                        int halo, float r2,
                                        cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  if (halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  halo = std::min(halo, N);
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
  return window_max_bwd_t(c, pos, m, g, dc, B, N, H, halo, r2, stream);
}

// C interface of the backward on bf16 values (c, m, g, dc bf16; pos f32);
// the same contract as window_max_fwd.
extern "C" int window_max_bwd_bf16(const __nv_bfloat16* c, const float* pos,
                                   const __nv_bfloat16* m,
                                   const __nv_bfloat16* g, __nv_bfloat16* dc,
                                   int B, int N, int H, int halo, float r2,
                                   cudaStream_t stream) {
  return window_max_bwd_t(c, pos, m, g, dc, B, N, H, halo, r2, stream);
}
