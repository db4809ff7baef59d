// GraphMET's three categorical embeddings as one op for Hopper (sm_90a):
// the lookup and the gradient of the three tables.
//
// Replaces no TPU kernel.  The JAX package looks the tables up with XLA's
// gather and sums their gradient with XLA's scatter-add (ROADMAP A2).  The
// port's plain composition (ops/cat_embed.py:cat_embed_torch: three
// w[idx] lookups and a cat) leaves the gradient to torch's
// index_put_(accumulate=True), whose sort-based kernel walks the ~10^4
// duplicates of each of a table's 3-8 rows one after another: ~23 ms a
// training step at B=8, N=8192, against the ~2 us below.  This file exists
// for that backward; the forward hands it the index rule.
//
// The index rule, for x_cat [rows, 3] int32 = (pdgId, charge, fromPV):
//   charge  k = clamp(charge + 1, 0, 2)
//   pdgId   k = the first i with |pdgId| == pdgs[i], else 0 (padding zeros
//               included)
//   fromPV  k = clamp(fromPV, 0, 7)
// with int32 wrap-around where torch wraps (charge + 1 at INT_MAX, |INT_MIN|),
// so every row gets the index the plain version gives it.  pdgs arrive as
// kernel arguments: a table on the card would be a host-to-device copy in
// every step, which a captured CUDA graph cannot hold.
//
// FORWARD (cat_embed_fwd_kernel).  out [rows, 3D] float32 in the order
// [charge | pdgId | fromPV], D the tables' width: one thread per output
// element reads its row's code (cached: the row's 3D threads share it) and
// copies one table entry.  A gather, so it equals the plain version bit for
// bit.
//
// BACKWARD (cat_embed_bwd_kernel, then cat_embed_sum_kernel).  dw_t[k, d] =
// the sum over every row (padded rows included, as the plain version sums
// them) with index k in table t of grad[row, t*D + d].  The indices are
// recomputed from x_cat, so the forward saves nothing else.
//  Pass 1: a fixed grid of at most BLOCKS = 264 blocks (2 per SM of an
//   H100), each over one contiguous chunk of rows.  A block of THREADS
//   threads reads RP = THREADS / 3D rows per step, thread t the element
//   row*3D + c with c = t % 3D and row = step row + t / 3D: consecutive
//   threads read consecutive addresses.  Each thread keeps, for its column,
//   one running float32 sum per row of that column's table (<= 8
//   registers), added to by a predicated add.  The block then reduces its
//   RP threads per column in shared memory by a fixed tree and writes one
//   partial [(3 + P + 8) * D] to scratch.
//  Pass 2: each output is the sum of the blocks' partials in block order,
//   in double (32 runs of consecutive blocks, then the runs in order),
//   rounded once.
// No atomics, and the grid depends only on rows and D: the result is the
// same bit for bit from call to call and between an eager call and a
// replayed CUDA graph.  Neither pass syncs or touches the host.
//
// What bounds it on the card: the backward must read grad and x_cat once,
// rows * (3D + 3) * 4 bytes (7.1 MB at B=8, N=8192, D=8: 2.1 us at 3.35
// TB/s); its arithmetic is one add per element (the predicated adds cost
// instructions, not bytes).  The forward writes rows * 3D floats and reads
// x_cat (the same 7.1 MB).  Both are bytes-bound: the design reads each byte
// once, coalesced, with 2 blocks per SM in flight and the per-thread loop
// unrolled so that several rows' loads are outstanding; the partials
// (264 * 18D floats) stay in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS = 264;     // pass 1's grid: 2 per SM of an H100
constexpr int MAX_D = 32;       // H <= 128, the window kernels' MAX_H
constexpr int MAX_ROWS = 8;     // rows of the largest table (fromPV)
constexpr int MAX_PDGS = 8;
constexpr int SUM_COLS = 8;     // pass 2: outputs per block
constexpr int SUM_RUNS = THREADS / SUM_COLS;

struct Pdgs {
  int n;
  int id[MAX_PDGS];
};

__device__ __forceinline__ int charge_index(int q) {
  const int v = static_cast<int>(static_cast<unsigned>(q) + 1u);
  return min(max(v, 0), 2);
}

__device__ __forceinline__ int pdg_index(int q, const Pdgs& p) {
  const unsigned a = q < 0 ? 0u - static_cast<unsigned>(q)
                           : static_cast<unsigned>(q);
  int k = 0;
#pragma unroll
  for (int i = MAX_PDGS - 1; i >= 0; --i)   // the first match wins
    if (i < p.n && a == static_cast<unsigned>(p.id[i])) k = i;
  return k;
}

__device__ __forceinline__ int pv_index(int q) { return min(max(q, 0), 7); }

// Table t's index of the row whose codes start at x: t = 0 charge,
// 1 pdgId, 2 fromPV.
__device__ __forceinline__ int table_index(const int* __restrict__ x, int t,
                                           const Pdgs& p) {
  if (t == 0) return charge_index(__ldg(x + 1));
  if (t == 1) return pdg_index(__ldg(x), p);
  return pv_index(__ldg(x + 2));
}

__global__ void __launch_bounds__(THREADS)
cat_embed_fwd_kernel(const int* __restrict__ x, const float* __restrict__ wc,
                     const float* __restrict__ wp,
                     const float* __restrict__ wv, float* __restrict__ out,
                     int total, int D, Pdgs pdgs) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int C = 3 * D;
  const int row = e / C, c = e - row * C;
  const int t = c / D, d = c - t * D;
  const int k = table_index(x + 3 * row, t, pdgs);
  const float* w = t == 0 ? wc : (t == 1 ? wp : wv);
  out[e] = __ldg(w + k * D + d);
}

// Pass 1: block b's partial [(3 + P + 8) * D] of the rows [b*chunk,
// min(n, (b+1)*chunk)).
__global__ void __launch_bounds__(THREADS)
cat_embed_bwd_kernel(const int* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ part, int n, int chunk, int D, int P,
                     Pdgs pdgs) {
  __shared__ float s[MAX_ROWS * 2 * THREADS];   // [MAX_ROWS][P2][C]
  const int C = 3 * D;
  const int RP = THREADS / C;
  int P2 = 1;
  while (P2 < RP) P2 <<= 1;
  const int tid = threadIdx.x;
  const int c = tid % C, r0 = tid / C;
  const int t = c / D;

  float acc[MAX_ROWS];
#pragma unroll
  for (int j = 0; j < MAX_ROWS; ++j) acc[j] = 0.0f;
  const int row0 = blockIdx.x * chunk;
  const int row1 = min(n, row0 + chunk);
  if (r0 < RP) {
#pragma unroll 4
    for (int row = row0 + r0; row < row1; row += RP) {
      const float v = __ldg(g + static_cast<size_t>(row) * C + c);
      const int k = table_index(x + 3 * static_cast<size_t>(row), t, pdgs);
#pragma unroll
      for (int j = 0; j < MAX_ROWS; ++j)
        if (j == k) acc[j] += v;
    }
  }
  // s holds RP slots per column and zeros up to P2 (P2 * C < 2 * THREADS)
  if (r0 < RP) {
#pragma unroll
    for (int j = 0; j < MAX_ROWS; ++j) s[(j * P2 + r0) * C + c] = acc[j];
  }
  for (int i = RP * C + tid; i < P2 * C; i += THREADS) {
    const int r = i / C, cc = i - r * C;
#pragma unroll
    for (int j = 0; j < MAX_ROWS; ++j) s[(j * P2 + r) * C + cc] = 0.0f;
  }
  __syncthreads();
  // the RP sums of each (table row, column) by a fixed tree
  for (int h = P2 >> 1; h > 0; h >>= 1) {
    for (int i = tid; i < MAX_ROWS * h * C; i += THREADS) {
      const int j = i / (h * C), rem = i - j * h * C;
      const int r = rem / C, cc = rem - r * C;
      s[(j * P2 + r) * C + cc] += s[(j * P2 + r + h) * C + cc];
    }
    __syncthreads();
  }
  const int W = (3 + P + 8) * D;
  for (int i = tid; i < MAX_ROWS * C; i += THREADS) {
    const int j = i / C, cc = i - j * C;
    const int tt = cc / D, d = cc - tt * D;
    const int rows = tt == 0 ? 3 : (tt == 1 ? P : 8);
    const int base = tt == 0 ? 0 : (tt == 1 ? 3 : 3 + P);
    if (j < rows)
      part[static_cast<size_t>(blockIdx.x) * W + (base + j) * D + d] =
          s[(j * P2) * C + cc];
  }
}

// Pass 2: out[e] = the sum of part[b * W + e] over b < nblk in double, in
// block order (SUM_RUNS runs of consecutive blocks, then the runs in
// order), rounded once; e indexes [charge | pdgId | fromPV] rows.
__global__ void __launch_bounds__(THREADS)
cat_embed_sum_kernel(const float* __restrict__ part, int nblk, int D, int P,
                     float* __restrict__ dwc, float* __restrict__ dwp,
                     float* __restrict__ dwv) {
  __shared__ double runs[SUM_RUNS][SUM_COLS];
  const int W = (3 + P + 8) * D;
  const int col = threadIdx.x % SUM_COLS, run = threadIdx.x / SUM_COLS;
  const int e = blockIdx.x * SUM_COLS + col;
  const int len = (nblk + SUM_RUNS - 1) / SUM_RUNS;
  const int k1 = min(nblk, (run + 1) * len);
  double acc = 0.0;
  if (e < W)
    for (int k = run * len; k < k1; ++k)
      acc += part[static_cast<size_t>(k) * W + e];
  runs[run][col] = acc;
  __syncthreads();
  if (run == 0 && e < W) {
    double sum = 0.0;
    for (int r = 0; r < SUM_RUNS; ++r) sum += runs[r][col];
    const float v = static_cast<float>(sum);
    const int row = e / D;
    if (row < 3)
      dwc[e] = v;
    else if (row < 3 + P)
      dwp[e - 3 * D] = v;
    else
      dwv[e - (3 + P) * D] = v;
  }
}

bool valid(int n, int D, int P, const int* ids, int n_pdgs, Pdgs* p) {
  if (n < 0 || D < 1 || D > MAX_D || P < 1 || P > MAX_ROWS || n_pdgs < 1 ||
      n_pdgs > P || static_cast<int64_t>(n) * 3 * D > INT32_MAX)
    return false;
  p->n = n_pdgs;
  for (int i = 0; i < MAX_PDGS; ++i) p->id[i] = i < n_pdgs ? ids[i] : 0;
  return true;
}

int rows_per_step(int D) { return THREADS / (3 * D); }

}  // namespace

// Pass 1's grid for n rows of width 3D: at most BLOCKS, and no block
// without a row.  The wrapper sizes the scratch [blocks, (3 + P + 8) * D].
extern "C" int cat_embed_bwd_blocks(int n, int D) {
  if (n <= 0 || D < 1 || D > MAX_D) return 0;
  const int rp = rows_per_step(D);
  const int steps = (n + rp - 1) / rp;
  return steps < BLOCKS ? steps : BLOCKS;
}

// out [n, 3D] from x [n, 3] int32 and the tables wc [3, D], wp [P, D],
// wv [8, D] (float32, contiguous); pdgs: n_pdgs <= P ids on the host.
extern "C" int cat_embed_fwd(const int* x, const float* wc, const float* wp,
                             const float* wv, float* out, int n, int D, int P,
                             const int* pdgs, int n_pdgs,
                             cudaStream_t stream) {
  Pdgs p;
  if (!valid(n, D, P, pdgs, n_pdgs, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = n * 3 * D;
  if (total == 0) return 0;
  cat_embed_fwd_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0,
                         stream>>>(x, wc, wp, wv, out, total, D, p);
  return static_cast<int>(cudaGetLastError());
}

// dwc [3, D], dwp [P, D], dwv [8, D] from grad [n, 3D] and x [n, 3];
// part is scratch of cat_embed_bwd_blocks(n, D) * (3 + P + 8) * D floats.
extern "C" int cat_embed_bwd(const int* x, const float* g, float* part,
                             float* dwc, float* dwp, float* dwv, int n, int D,
                             int P, const int* pdgs, int n_pdgs,
                             cudaStream_t stream) {
  Pdgs p;
  if (!valid(n, D, P, pdgs, n_pdgs, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = cat_embed_bwd_blocks(n, D);
  if (nblk > 0) {
    const int chunk = (n + nblk - 1) / nblk;
    cat_embed_bwd_kernel<<<nblk, THREADS, 0, stream>>>(x, g, part, n, chunk,
                                                       D, P, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int W = (3 + P + 8) * D;
  cat_embed_sum_kernel<<<(W + SUM_COLS - 1) / SUM_COLS, THREADS, 0,
                         stream>>>(part, nblk, D, P, dwc, dwp, dwv);
  return static_cast<int>(cudaGetLastError());
}
