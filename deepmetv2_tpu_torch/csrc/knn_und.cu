// Fused undirected kNN graph build for Hopper (sm_90a): the threshold
// kernel and the extraction kernel of the DRN's dynamic graph.
//
// Replaces the Pallas TPU kernels of deepmetv2_tpu/ops/pallas/knn_und.py:
// _kth_kernel (pallas_call in knn_und_graph) and _extract_kernel (its
// second pallas_call).  For h [B,N,H] f32 and mask [B,N] (bool bytes):
//
//   d2(i,j) = max((sq_i + sq_j) - 2*dot(i,j), 0),  +inf unless valid_j, j != i
//   knn_kth:     t[b,i]   = k-th smallest d2(i,.) counted with multiplicity
//                           (+inf when fewer than k sources are valid)
//   knn_extract: U(i,j)   = (d2 <= t_i || d2 <= t_j) && valid_j && j != i;
//                idx/d2v  = the first cap members of row i in ascending
//                           (d2, j) order (0 / +inf where the row runs dry);
//                rel[b,i,j] = U(i,j) as a byte (optional)
//
// sq and dot are summed over h in ascending order with __fmul_rn/__fadd_rn
// (never contracted into an FMA), and sq_i + sq_j is commutative, so d2 is
// symmetric bit for bit, t_i is exactly one of the values the extraction
// compares against it, and both kernels equal the plain PyTorch version
// (ops/knn_und.py) bit for bit.  Rows of padded queries are computed like
// any other row; the caller masks them.
//
// Design.  A block owns R query rows of one event (R warps, one row each);
// each warp keeps its query's whole masked d2 row in shared memory (R is
// chosen so R rows fit in 160 KB: 8 rows up to N = 5120, 5 at N = 8192).
// The block walks the event's sources in 32-row chunks staged in shared
// memory (row stride H+1 when H is even, so lane j reads row j without bank
// conflicts); lane j computes d2 of its warp's query against source s0+j.
// Then the warp selects from its row: k (resp. cap) rounds of a warp-wide
// argmin over (d2, index), removing the winner each round, with an early
// exit once the row is dry.  The squared norms come from a small pass of
// their own (knn_sqnorm_kernel) ahead of knn_kth, which returns them; the
// extraction reads them back.  Every output is written once; no atomics.
//
// What bounds it on the card: the distance products the data needs, one
// per pair of real nodes of an event, each pair once (d2 is symmetric):
// H*n*(n-1) FP32 operations per event of n real nodes (the TPU used its
// MXU; TF32 is ruled out by the f32 contract), against the bytes of h and
// the outputs, with the extraction's B*N*N relation bytes (168 MB at
// B=40, N=2048: 0.05 ms at 3.35 TB/s) the largest; chip_smoke.py computes
// both from its data.  The kernels compute every padded row and every
// pair twice, are limited by shared-memory loads (two per product term,
// the query's as a broadcast) and use separate multiply and add
// instructions, half the FMA rate: times in PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int CHUNK = 32;                  // sources staged per step
constexpr int MAX_ROWS = 8;                // query rows (warps) per block
constexpr int ROW_BUDGET = 160 * 1024;     // bytes of d2 rows per block
constexpr unsigned FULL = 0xffffffffu;

int rows_per_block(int N) {
  int r = ROW_BUDGET / (N * 4);
  return r < 1 ? 1 : (r > MAX_ROWS ? MAX_ROWS : r);
}

__host__ __device__ int src_stride(int H) { return (H % 2 == 0) ? H + 1 : H; }

size_t smem_bytes(int R, int N, int H) {
  return sizeof(float) * (static_cast<size_t>(R) * H + CHUNK * src_stride(H)
                          + 3 * CHUNK + static_cast<size_t>(R) * N);
}

__global__ void knn_sqnorm_kernel(const float* __restrict__ h,
                                  float* __restrict__ sq, int rows, int H) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* v = h + static_cast<size_t>(r) * H;
  float a = 0.f;
  for (int c = 0; c < H; ++c) a = __fadd_rn(a, __fmul_rn(v[c], v[c]));
  sq[r] = a;
}

// Warp-wide argmin over (value, index), lowest index among equal values;
// every lane ends with the same pair.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// The smallest (value, index) of this lane's share of a row (entries
// lane, lane+32, ...), then of the whole row.  Index N when all are +inf.
__device__ __forceinline__ void row_argmin(const float* row, int N, int lane,
                                           float& best, int& bi) {
  best = CUDART_INF_F;
  bi = N;
  for (int j = lane; j < N; j += 32) {
    const float v = row[j];
    if (v < best) {
      best = v;
      bi = j;
    }
  }
  warp_argmin(best, bi);
}

template <bool EXTRACT>
__global__ void knn_kernel(const float* __restrict__ h,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ sq,
                           const float* __restrict__ t_in,
                           float* __restrict__ t_out,
                           int* __restrict__ idx_out,
                           float* __restrict__ d2v_out,
                           unsigned char* __restrict__ rel_out, int N, int H,
                           int kc /* k, or cap */) {
  extern __shared__ float smem[];
  const int R = blockDim.x >> 5;
  const int Hs = src_stride(H);
  float* q_s = smem;                         // [R][H]
  float* src_s = q_s + R * H;                // [CHUNK][Hs]
  float* sq_s = src_s + CHUNK * Hs;          // [CHUNK]
  float* tj_s = sq_s + CHUNK;                // [CHUNK]
  float* ok_s = tj_s + CHUNK;                // [CHUNK] 1 = valid source
  float* rows = ok_s + CHUNK;                // [R][N]

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * R + warp;       // this warp's query row
  const bool live = i < N;
  const size_t eb = static_cast<size_t>(b) * N;
  const float* hb = h + eb * H;

  for (int e = threadIdx.x; e < R * H; e += blockDim.x) {
    const int qi = blockIdx.x * R + e / H;
    q_s[e] = qi < N ? hb[static_cast<size_t>(blockIdx.x) * R * H + e] : 0.f;
  }
  const float* q = q_s + warp * H;
  const float sqi = live ? sq[eb + i] : 0.f;
  const float ti = (EXTRACT && live) ? t_in[eb + i] : 0.f;
  float* row = rows + static_cast<size_t>(warp) * N;
  unsigned char* rel_row =
      (EXTRACT && rel_out && live) ? rel_out + (eb + i) * N : nullptr;

  for (int s0 = 0; s0 < N; s0 += CHUNK) {
    const int cnt = min(CHUNK, N - s0);
    __syncthreads();  // the previous chunk has been consumed
    const float* src = hb + static_cast<size_t>(s0) * H;
    for (int e = threadIdx.x; e < cnt * H; e += blockDim.x) {
      const int r = e / H;
      src_s[r * Hs + (e - r * H)] = src[e];
    }
    if (threadIdx.x < cnt) {
      const int j = s0 + threadIdx.x;
      sq_s[threadIdx.x] = sq[eb + j];
      ok_s[threadIdx.x] = mask[eb + j] ? 1.f : 0.f;
      if (EXTRACT) tj_s[threadIdx.x] = t_in[eb + j];
    }
    __syncthreads();
    if (live && lane < cnt) {
      const int j = s0 + lane;
      const float* v = src_s + lane * Hs;
      float dot = 0.f;
      for (int c = 0; c < H; ++c) dot = __fadd_rn(dot, __fmul_rn(q[c], v[c]));
      const float d2 =
          fmaxf(__fsub_rn(__fadd_rn(sqi, sq_s[lane]), __fmul_rn(2.f, dot)),
                0.f);
      const bool valid = ok_s[lane] != 0.f && j != i;
      if (EXTRACT) {
        const bool u = valid && (d2 <= ti || d2 <= tj_s[lane]);
        if (rel_row) rel_row[j] = u ? 1 : 0;
        row[j] = u ? d2 : CUDART_INF_F;
      } else {
        row[j] = valid ? d2 : CUDART_INF_F;
      }
    }
  }
  if (!live) return;  // no block-wide barrier below
  __syncwarp();

  if (!EXTRACT) {
    float m = CUDART_INF_F;
    for (int it = 0; it < kc; ++it) {
      int bi;
      row_argmin(row, N, lane, m, bi);
      if (bi == N) break;  // dry: the k-th smallest is +inf
      if ((bi & 31) == lane) row[bi] = CUDART_INF_F;
      __syncwarp();
    }
    if (lane == 0) t_out[eb + i] = m;
    return;
  }

  int* io = idx_out + (eb + i) * kc;
  float* dv = d2v_out + (eb + i) * kc;
  int c = 0;
  for (; c < kc; ++c) {
    float m;
    int bi;
    row_argmin(row, N, lane, m, bi);
    if (bi == N) break;
    if (lane == 0) {
      io[c] = bi;
      dv[c] = m;
    }
    if ((bi & 31) == lane) row[bi] = CUDART_INF_F;
    __syncwarp();
  }
  for (int cc = c + lane; cc < kc; cc += 32) {
    io[cc] = 0;
    dv[cc] = CUDART_INF_F;
  }
}

cudaError_t launch(bool extract, const float* h, const unsigned char* mask,
                   const float* sq, const float* t_in, float* t_out, int* idx,
                   float* d2v, unsigned char* rel, int B, int N, int H,
                   int kc, cudaStream_t stream) {
  const int R = rows_per_block(N);
  const size_t smem = smem_bytes(R, N, H);
  const dim3 grid((N + R - 1) / R, B);
  cudaError_t err;
  if (extract) {
    err = cudaFuncSetAttribute(knn_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    knn_kernel<true><<<grid, R * 32, smem, stream>>>(
        h, mask, sq, t_in, nullptr, idx, d2v, rel, N, H, kc);
  } else {
    err = cudaFuncSetAttribute(knn_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    knn_kernel<false><<<grid, R * 32, smem, stream>>>(
        h, mask, sq, nullptr, t_out, nullptr, nullptr, nullptr, N, H, kc);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// t [B,N] and the squared norms sq [B,N] from h [B,N,H] and mask [B,N].
int knn_kth(const float* h, const unsigned char* mask, float* sq, float* t,
            int B, int N, int H, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * N;
  knn_sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(h, sq, rows, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(false, h, mask, sq, nullptr, t, nullptr,
                                 nullptr, nullptr, B, N, H, k, st));
}

// idx, d2v [B,N,cap] and (when rel is not null) rel [B,N,N] from h, mask,
// the thresholds t and the squared norms sq, both from knn_kth.
int knn_extract(const float* h, const unsigned char* mask, const float* t,
                const float* sq, int* idx, float* d2v, unsigned char* rel,
                int B, int N, int H, int cap, void* stream) {
  return static_cast<int>(launch(true, h, mask, sq, t, nullptr, idx, d2v,
                                 rel, B, N, H, cap,
                                 static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
