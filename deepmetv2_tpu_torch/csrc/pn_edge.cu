// ParticleNet's EdgeConv edge block for Hopper (sm_90a): the three 1x1
// convolutions over the edge features [x_i, x_j - x_i] with BatchNorm over
// the real edges and ReLU after each, and the mean over each node's slots,
// forward and backward, in float32 on the CUDA cores.
//
// For x [B,N,Cin], the directed lists idx / smask [B,N,K] (smask: the slot
// holds a real neighbour) and weights w1 [2Cin,C], w2, w3 [C,C]:
//
//   z0 = x_i.(w1a - w1b) + x_j.w1b           (the first layer, factored)
//   z1 = h0.w2,  z2 = h1.w3,   h_l = max(z_l*s_l + t_l, 0)
//   s_l = gamma_l * rstd_l,  t_l = beta_l - mean_l * s_l
//   y_i = the mean of h2 over i's real slots (0 for a node with none)
//
// where mean_l, rstd_l are the biased statistics of z_l over the real edges
// in training (computed here) and the caller's running ones in evaluation.
// The plain PyTorch version is ops/pn_edge.py:edge_block_torch.
//
// Design.  Rows are edges (b, i, k), B*N*K of them, laid out as the lists
// are.  Collation puts each event's real candidates first, so a tile of
// BM = 128 rows (8 nodes at K = 16) past cnt[b] real nodes holds no real
// edge: every kernel skips such a tile (the GEMMs exit at once), so the
// arithmetic and the traffic follow the real edges, not the padding.
// Rows of a skipped tile are never written and never read; rows of a
// working tile are always written (0 where a slot is empty), so nothing
// reads memory it did not write.
//  - pn_edge_gemm_kernel: C = op(A).W over the rows of working tiles, 128 x
//    BN output tiles in registers (8 x 8 or 8 x 4 per thread), A staged
//    transposed and W staged in shared memory 8 deep, double-buffered
//    through registers.  op applies the previous layer's BatchNorm and ReLU
//    as A is staged (so h_l is never stored), and the epilogue writes each
//    tile's column sums and sums of squares over its real rows (the next
//    BatchNorm's statistics partials).
//  - pn_edge_wgrad_kernel: dW = op(A)^T.G, each block a 128 x BN output tile
//    over one chunk of rows, its partial written whole.
//  - pn_edge_gather_kernel: z0 = a[i] + p[j] from the per-node projection
//    [a | p] = x.[w1a - w1b | w1b] (one GEMM over the nodes), with its
//    statistics partials; pn_edge_mean_kernel: the last BatchNorm, the ReLU
//    and the mean over the slots.
//  - Backward, per layer from the last: pn_edge_bn_bwd_kernel twice (the
//    sums of gu and gu*xhat, then dz = gamma*rstd*(gu - mean gu - xhat *
//    mean(gu*xhat))), the weight gradient, dh = dz.W^T; for the first layer
//    pn_edge_node_grad_kernel sums dz onto i (its slots) and onto j (the
//    reverse index of the lists, ops/cuda/edge_mlp.py:reverse_index), then
//    dx and dw1 are GEMMs over the nodes.
//  - Every partial is summed in a fixed order in double
//    (pn_edge_sum1_kernel, pn_edge_sum2_kernel): no float atomics anywhere,
//    so a call repeats bit for bit.
//
// What bounds it: the GEMMs' FP32 operations over the real edges, 2*C*C per
// edge and layer (two layers forward, four backward), against 67 TFLOP/s;
// the elementwise passes' bytes against 3.35 TB/s (portbench/counts/
// pn_edge.py).  TF32 is never used: the tensor cores' rounding would keep
// three decimal digits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;          // rows per tile
constexpr int BK = 8;            // depth of a staged slice
constexpr int AP = BM + 4;       // padded row of the staged A slice
constexpr int SUM_GROUP = 64;    // partials per first-stage sum
constexpr int MAX_CHUNKS = 256;  // row chunks of a weight gradient

// The row space of a kernel: events of `per_event` rows, of which the first
// cnt[b] * rk may hold real ones (rk = K for edges, 1 for nodes).
struct Rows {
  const int* cnt;
  int per_event, rk;
  __device__ bool active(int row0) const {
    const int b = row0 / per_event;
    return row0 - b * per_event < cnt[b] * rk;
  }
};

__device__ __forceinline__ float bn_relu(float v, float s, float t) {
  return fmaxf(fmaf(v, s, t), 0.f);
}

// ----------------------------------------------------------------- GEMMs

// C [R, Nout] = op(A) [R, K] . W [K, Nout] over the working tiles;
// op(A)[r, k] = max(A*s[k] + t[k], 0) where s is given, else A.  With
// part: part[tile][0 | 1][Nout] = the column sums and sums of squares of
// the tile's rows where rowmask holds (zeros for a skipped tile).
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pn_edge_gemm_kernel(const float* __restrict__ A, int lda,
                    const float* __restrict__ s, const float* __restrict__ t,
                    const float* __restrict__ W, float* __restrict__ C,
                    int K, int Nout, Rows rows,
                    const unsigned char* __restrict__ rowmask,
                    float* __restrict__ part) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float smem[2 * BK * AP + 2 * BK * BN];
  float* As = smem;                  // [2][BK][AP]
  float* Bs = smem + 2 * BK * AP;    // [2][BK][BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (!rows.active(row0)) {
    if (part)
      for (int e = tid; e < 2 * BN; e += THREADS) {
        const int w = e / BN, c = n0 + e % BN;
        if (c < Nout)
          part[(static_cast<size_t>(blockIdx.x) * 2 + w) * Nout + c] = 0.f;
      }
    return;
  }

  // this thread's share of a slice: A row ar, depth ak..ak+3; W depth br,
  // columns bc..bc+3 (only the first BK*BN/4 threads load W)
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const bool wl = tid < BK * BN / 4;
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
  const float* arow = A + static_cast<size_t>(row0 + ar) * lda;
  float ra[4], rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) ra[j] = 0.f;
    const int ka = k0 + ak;
    if (VEC) {
      if (ka < K) {
        const float4 v = *reinterpret_cast<const float4*>(arow + ka);
        ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ka + j < K) ra[j] = arow[ka + j];
    }
    if (s) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ka + j < K) ra[j] = bn_relu(ra[j], s[ka + j], t[ka + j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) rb[j] = 0.f;
    if (wl && k0 + br < K) {
      const float* wrow = W + static_cast<size_t>(k0 + br) * Nout + n0 + bc;
      if (VEC) {
        if (n0 + bc < Nout) {
          const float4 v = *reinterpret_cast<const float4*>(wrow);
          rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + bc + j < Nout) rb[j] = wrow[j];
      }
    }
  };
  auto store = [&](int buf) {
    float* as = As + buf * BK * AP;
#pragma unroll
    for (int j = 0; j < 4; ++j) as[(ak + j) * AP + ar] = ra[j];
    if (wl)
      *reinterpret_cast<float4*>(Bs + buf * BK * BN + br * BN + bc) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
    const float* as = As + buf * BK * AP;
    const float* bs = Bs + buf * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * AP + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * AP + 64 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + tx * 4);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + kk * BN + 64 + tx * 4);
        b[TN - 4] = b1.x; b[TN - 3] = b1.y; b[TN - 2] = b1.z; b[TN - 1] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float cs[TN], cq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) cs[j] = cq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    float* crow = C + static_cast<size_t>(r) * Nout + n0;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = h * 64 + tx * 4;
      if (VEC) {
        if (n0 + c < Nout)
          *reinterpret_cast<float4*>(crow + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c + j < Nout) crow[c + j] = acc[i][4 * h + j];
      }
    }
    if (part && rowmask[r]) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        cs[j] += acc[i][j];
        cq[j] = fmaf(acc[i][j], acc[i][j], cq[j]);
      }
    }
  }
  if (!part) return;
  float* red = smem;  // [2][16][BN]; the slices are no longer read
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = (j / 4) * 64 + tx * 4 + j % 4;
    red[ty * BN + c] = cs[j];
    red[16 * BN + ty * BN + c] = cq[j];
  }
  __syncthreads();
  for (int e = tid; e < 2 * BN; e += THREADS) {
    const int w = e / BN, c = e % BN;
    float v = 0.f;
    for (int y = 0; y < 16; ++y) v += red[w * 16 * BN + y * BN + c];
    if (n0 + c < Nout)
      part[(static_cast<size_t>(blockIdx.x) * 2 + w) * Nout + n0 + c] = v;
  }
}

// part[chunk][M][Nout] = sum over the chunk's working tiles' rows r of
// op(A)[r, m] * G[r, n]; op as in pn_edge_gemm_kernel.  Each block owns a
// 128 x BN tile of the output over one chunk of rows.
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pn_edge_wgrad_kernel(const float* __restrict__ A, int lda,
                     const float* __restrict__ s, const float* __restrict__ t,
                     const float* __restrict__ G, int ldg, int M, int Nout,
                     int R, int chunk_rows, Rows rows,
                     float* __restrict__ part) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float As[2 * BK * BM];
  __shared__ __align__(16) float Bs[2 * BK * BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = min(R, r_begin + chunk_rows);
  // A: depth row kr, columns mc..mc+3; G: depth row br, columns bc..bc+3
  const int kr = tid >> 5, mc = (tid & 31) * 4;
  const bool gl = tid < BK * BN / 4;
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
  float ra[4], rb[4];

  auto next_tile = [&](int r) {  // the first working tile at or after r
    while (r < r_end && !rows.active(r)) r += BM;
    return r;
  };
  auto load = [&](int r0) {
    const float* arow = A + static_cast<size_t>(r0 + kr) * lda + m0 + mc;
#pragma unroll
    for (int j = 0; j < 4; ++j) ra[j] = 0.f;
    if (VEC) {
      if (m0 + mc < M) {
        const float4 v = *reinterpret_cast<const float4*>(arow);
        ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + mc + j < M) ra[j] = arow[j];
    }
    if (s) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + mc + j < M)
          ra[j] = bn_relu(ra[j], s[m0 + mc + j], t[m0 + mc + j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) rb[j] = 0.f;
    if (gl) {
      const float* grow = G + static_cast<size_t>(r0 + br) * ldg + n0 + bc;
      if (VEC) {
        if (n0 + bc < Nout) {
          const float4 v = *reinterpret_cast<const float4*>(grow);
          rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + bc + j < Nout) rb[j] = grow[j];
      }
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(As + buf * BK * BM + kr * BM + mc) =
        make_float4(ra[0], ra[1], ra[2], ra[3]);
    if (gl)
      *reinterpret_cast<float4*>(Bs + buf * BK * BN + br * BN + bc) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int r = next_tile(r_begin);
  if (r < r_end) {
    load(r);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  while (r < r_end) {
    int rn = r + BK;
    if (rn % BM == 0) rn = next_tile(rn);
    const bool more = rn < r_end;
    if (more) load(rn);
    const float* as = As + buf * BK * BM;
    const float* bs = Bs + buf * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * BM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * BM + 64 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + tx * 4);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + kk * BN + 64 + tx * 4);
        b[TN - 4] = b1.x; b[TN - 3] = b1.y; b[TN - 2] = b1.z; b[TN - 1] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
    r = rn;
  }

  float* out = part + static_cast<size_t>(blockIdx.x) * M * Nout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (n < Nout) out[static_cast<size_t>(m) * Nout + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------- ordered sums

// tmp[g][e] = sum of part[p][e] over the parts p of group g, in order.
__global__ void __launch_bounds__(THREADS)
pn_edge_sum1_kernel(const float* __restrict__ part, int np, int n,
                    double* __restrict__ tmp) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const int p0 = blockIdx.y * SUM_GROUP, p1 = min(np, p0 + SUM_GROUP);
  double acc = 0.0;
  for (int p = p0; p < p1; ++p) acc += part[static_cast<size_t>(p) * n + e];
  tmp[static_cast<size_t>(blockIdx.y) * n + e] = acc;
}

// out[e] = sum of tmp[g][e] over the groups in order (double and/or f32).
__global__ void __launch_bounds__(THREADS)
pn_edge_sum2_kernel(const double* __restrict__ tmp, int ng, int n,
                    double* __restrict__ out_d, float* __restrict__ out_f) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  double acc = 0.0;
  for (int g = 0; g < ng; ++g) acc += tmp[static_cast<size_t>(g) * n + e];
  if (out_d) out_d[e] = acc;
  if (out_f) out_f[e] = static_cast<float>(acc);
}

// ------------------------------------------------------ edge-wise passes

// z [R, C] over the working tiles: a[i] + p[j] at real slots, 0 elsewhere,
// from ap [B*N][2C] = [a | p]; part[tile][2][C]: the sums and sums of
// squares over the tile's real slots (zeros for a skipped tile).
__global__ void __launch_bounds__(THREADS)
pn_edge_gather_kernel(const float* __restrict__ ap,
                      const int* __restrict__ idx,
                      const unsigned char* __restrict__ smask,
                      float* __restrict__ z, int N, int K, int C, Rows rows,
                      float* __restrict__ part) {
  __shared__ float red[2 * THREADS];
  const int tid = threadIdx.x, G = THREADS / C, g = tid / C, c = tid % C;
  const int row0 = blockIdx.x * BM;
  const bool work = rows.active(row0);
  float s1 = 0.f, s2 = 0.f;
  if (work && g < G) {
    for (int r = g; r < BM; r += G) {
      const int row = row0 + r, node = row / K, b = node / N;
      float v = 0.f;
      if (smask[row]) {
        v = ap[static_cast<size_t>(node) * 2 * C + c]
            + ap[(static_cast<size_t>(b) * N + idx[row]) * 2 * C + C + c];
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
      z[static_cast<size_t>(row) * C + c] = v;
    }
  }
  if (!part) return;
  if (g < G) {
    red[g * C + c] = s1;
    red[THREADS + g * C + c] = s2;
  }
  __syncthreads();
  if (tid < C) {
    float a = 0.f, q = 0.f;
    for (int y = 0; y < G; ++y) {
      a += red[y * C + tid];
      q += red[THREADS + y * C + tid];
    }
    part[(static_cast<size_t>(blockIdx.x) * 2) * C + tid] = a;
    part[(static_cast<size_t>(blockIdx.x) * 2 + 1) * C + tid] = q;
  }
}

// y [nodes, C]: the mean over the node's real slots of max(z*s + t, 0), 0
// for a node with none; inv_deg [nodes]: 1 / its real slots (0 for none).
__global__ void __launch_bounds__(THREADS)
pn_edge_mean_kernel(const float* __restrict__ z,
                    const unsigned char* __restrict__ smask,
                    const float* __restrict__ s, const float* __restrict__ t,
                    const int* __restrict__ cnt, float* __restrict__ y,
                    float* __restrict__ inv_deg, int N, int K, int C,
                    int nodes) {
  const int G = THREADS / C, g = threadIdx.x / C, c = threadIdx.x % C;
  const int node = blockIdx.x * G + g;
  if (g >= G || node >= nodes) return;
  const int b = node / N;
  float acc = 0.f;
  int deg = 0;
  if (node - b * N < cnt[b]) {
    for (int k = 0; k < K; ++k) {
      const size_t row = static_cast<size_t>(node) * K + k;
      if (smask[row]) {
        acc += bn_relu(z[row * C + c], s[c], t[c]);
        ++deg;
      }
    }
  }
  y[static_cast<size_t>(node) * C + c] = deg ? acc / static_cast<float>(deg)
                                             : 0.f;
  if (c == 0) inv_deg[node] = deg ? 1.f / static_cast<float>(deg) : 0.f;
}

// The BatchNorm-and-ReLU backward of one layer over the working tiles.
// With u = z*s + t and xh = (z - mean)*rstd (st rows s, t, mean, rstd), gu
// = gh * (u > 0) at real slots, gh = G[row] where G is given, else the mean's
// gy[node] * inv_deg[node].  Without coef: part[tile][2][C] = (sum gu, sum
// gu*xh) over the tile's real slots.  With coef (the two means): out[row] =
// gamma*rstd*(gu - coef[0] - xh*coef[1]) at real slots, 0 elsewhere (out
// may be G).
__global__ void __launch_bounds__(THREADS)
pn_edge_bn_bwd_kernel(const float* __restrict__ z, const float* G,
                      const float* __restrict__ gy,
                      const float* __restrict__ inv_deg,
                      const unsigned char* __restrict__ smask,
                      const float* __restrict__ st,
                      const float* __restrict__ gamma,
                      const float* __restrict__ coef, float* out, int K,
                      int C, Rows rows, float* __restrict__ part) {
  __shared__ float red[2 * THREADS];
  const int tid = threadIdx.x, NG = THREADS / C, g = tid / C, c = tid % C;
  const int row0 = blockIdx.x * BM;
  const bool work = rows.active(row0);
  float s1 = 0.f, s2 = 0.f;
  if (work && g < NG) {
    const float s = st[c], t = st[C + c], mean = st[2 * C + c],
                rstd = st[3 * C + c];
    const float m1 = coef ? coef[c] : 0.f, m2 = coef ? coef[C + c] : 0.f;
    const float gr = coef ? gamma[c] * rstd : 0.f;
    for (int r = g; r < BM; r += NG) {
      const size_t row = static_cast<size_t>(row0 + r);
      float v = 0.f;
      if (smask[row]) {
        const float zv = z[row * C + c];
        const float gh = G ? G[row * C + c]
                           : gy[(row / K) * C + c] * inv_deg[row / K];
        const float gu = fmaf(zv, s, t) > 0.f ? gh : 0.f;
        const float xh = (zv - mean) * rstd;
        s1 += gu;
        s2 = fmaf(gu, xh, s2);
        v = gr * (gu - m1 - xh * m2);
      }
      if (coef) out[row * C + c] = v;
    }
  }
  if (coef) return;
  if (g < NG) {
    red[g * C + c] = s1;
    red[THREADS + g * C + c] = s2;
  }
  __syncthreads();
  if (tid < C) {
    float a = 0.f, q = 0.f;
    for (int y = 0; y < NG; ++y) {
      a += red[y * C + tid];
      q += red[THREADS + y * C + tid];
    }
    part[(static_cast<size_t>(blockIdx.x) * 2) * C + tid] = a;
    part[(static_cast<size_t>(blockIdx.x) * 2 + 1) * C + tid] = q;
  }
}

// The first layer's gradient onto the nodes: dap [nodes][2C] = [da | dp],
// da[i] = the sum of dz over i's real slots, dp[j] = the sum of dz over the
// slots that list j (the reverse index: order [B][N*K], offsets [B][N+1]),
// each in its order; 0 for padded nodes.
__global__ void __launch_bounds__(THREADS)
pn_edge_node_grad_kernel(const float* __restrict__ dz,
                         const unsigned char* __restrict__ smask,
                         const int* __restrict__ order,
                         const int* __restrict__ offsets,
                         const int* __restrict__ cnt, float* __restrict__ dap,
                         int N, int K, int C, int nodes) {
  const int G = THREADS / C, g = threadIdx.x / C, c = threadIdx.x % C;
  const int node = blockIdx.x * G + g;
  if (g >= G || node >= nodes) return;
  const int b = node / N, i = node - b * N;
  float da = 0.f, dp = 0.f;
  if (i < cnt[b]) {
    for (int k = 0; k < K; ++k) {
      const size_t row = static_cast<size_t>(node) * K + k;
      if (smask[row]) da += dz[row * C + c];
    }
    const int* ob = order + static_cast<size_t>(b) * N * K;
    const int o0 = offsets[static_cast<size_t>(b) * (N + 1) + i];
    const int o1 = offsets[static_cast<size_t>(b) * (N + 1) + i + 1];
    for (int q = o0; q < o1; ++q)
      dp += dz[(static_cast<size_t>(b) * N * K + ob[q]) * C + c];
  }
  dap[static_cast<size_t>(node) * 2 * C + c] = da;
  dap[static_cast<size_t>(node) * 2 * C + C + c] = dp;
}

// ------------------------------------------------- per-channel constants

// st [5][C] = s, t, mean, rstd, var from sums [2][C] (sum, sum of squares)
// over n rows: the biased variance, clamped at 0.
__global__ void pn_edge_affine_kernel(const double* __restrict__ sums,
                                      const double* __restrict__ n,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      float eps, float* __restrict__ st,
                                      int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const double rows = n[0] > 1.0 ? n[0] : 1.0;
  const double mean = sums[c] / rows;
  double var = sums[C + c] / rows - mean * mean;
  var = var > 0.0 ? var : 0.0;
  const float rstd = static_cast<float>(1.0 / sqrt(var + eps));
  const float sc = gamma[c] * rstd;
  st[c] = sc;
  st[C + c] = beta[c] - static_cast<float>(mean) * sc;
  st[2 * C + c] = static_cast<float>(mean);
  st[3 * C + c] = rstd;
  st[4 * C + c] = static_cast<float>(var);
}

// coef [2][C] = the means of gu and gu*xh over n rows from their sums;
// dgamma = sum gu*xh, dbeta = sum gu.
__global__ void pn_edge_coef_kernel(const double* __restrict__ sums,
                                    const double* __restrict__ n,
                                    float* __restrict__ coef,
                                    float* __restrict__ dgamma,
                                    float* __restrict__ dbeta, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const double rows = n[0] > 1.0 ? n[0] : 1.0;
  coef[c] = static_cast<float>(sums[c] / rows);
  coef[C + c] = static_cast<float>(sums[C + c] / rows);
  dbeta[c] = static_cast<float>(sums[c]);
  dgamma[c] = static_cast<float>(sums[C + c]);
}

// ------------------------------------------------------------- launchers

#define PN_TRY(x)                          \
  do {                                     \
    const cudaError_t e_ = (x);            \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

int tiles(int R) { return (R + BM - 1) / BM; }

int chunks(int R) { return tiles(R) < MAX_CHUNKS ? tiles(R) : MAX_CHUNKS; }

int chunk_rows(int R) {
  const int per = (tiles(R) + chunks(R) - 1) / chunks(R);
  return per * BM;
}

int groups(int np) { return (np + SUM_GROUP - 1) / SUM_GROUP; }

cudaError_t gemm(const float* A, int lda, const float* s, const float* t,
                 const float* W, float* C, int R, int K, int Nout, Rows rows,
                 const unsigned char* rowmask, float* part,
                 cudaStream_t st) {
  const bool vec = K % 4 == 0 && lda % 4 == 0 && Nout % 4 == 0;
  if (Nout > 64) {
    const dim3 grid(tiles(R), (Nout + 127) / 128);
    if (vec)
      pn_edge_gemm_kernel<128, true><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, W, C, K, Nout, rows, rowmask, part);
    else
      pn_edge_gemm_kernel<128, false><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, W, C, K, Nout, rows, rowmask, part);
  } else {
    const dim3 grid(tiles(R), 1);
    if (vec)
      pn_edge_gemm_kernel<64, true><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, W, C, K, Nout, rows, rowmask, part);
    else
      pn_edge_gemm_kernel<64, false><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, W, C, K, Nout, rows, rowmask, part);
  }
  return cudaGetLastError();
}

// out [n] (double and/or f32) = the ordered sum of part [np][n]
cudaError_t ordered_sum(const float* part, int np, int n, double* tmp,
                        double* out_d, float* out_f, cudaStream_t st) {
  const int ng = groups(np), nb = (n + THREADS - 1) / THREADS;
  pn_edge_sum1_kernel<<<dim3(nb, ng), THREADS, 0, st>>>(part, np, n, tmp);
  PN_TRY(cudaGetLastError());
  pn_edge_sum2_kernel<<<nb, THREADS, 0, st>>>(tmp, ng, n, out_d, out_f);
  return cudaGetLastError();
}

// out [M][Nout] (f32) = op(A)^T . G over the working tiles of R rows
cudaError_t wgrad(const float* A, int lda, const float* s, const float* t,
                  const float* G, int ldg, float* out, int R, int M,
                  int Nout, Rows rows, float* part, double* tmp,
                  cudaStream_t st) {
  const bool vec = M % 4 == 0 && lda % 4 == 0 && Nout % 4 == 0 &&
                   ldg % 4 == 0;
  const int nch = chunks(R), cr = chunk_rows(R);
  if (Nout > 64) {
    const dim3 grid(nch, (M + BM - 1) / BM, (Nout + 127) / 128);
    if (vec)
      pn_edge_wgrad_kernel<128, true><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, G, ldg, M, Nout, R, cr, rows, part);
    else
      pn_edge_wgrad_kernel<128, false><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, G, ldg, M, Nout, R, cr, rows, part);
  } else {
    const dim3 grid(nch, (M + BM - 1) / BM, 1);
    if (vec)
      pn_edge_wgrad_kernel<64, true><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, G, ldg, M, Nout, R, cr, rows, part);
    else
      pn_edge_wgrad_kernel<64, false><<<grid, THREADS, 0, st>>>(
          A, lda, s, t, G, ldg, M, Nout, R, cr, rows, part);
  }
  PN_TRY(cudaGetLastError());
  return ordered_sum(part, nch, M * Nout, tmp, nullptr, out, st);
}

}  // namespace

extern "C" {

// The scratch the callers allocate for widths Cin, C at B, N, K: out[0] the
// f32 partials, out[1] the double first-stage sums.
int pn_edge_scratch(int B, int N, int K, int Cin, int C, long long* out) {
  const int Re = B * N * K, Rn = B * N;
  const long long stats = static_cast<long long>(tiles(Re)) * 2 * C;
  const long long we = static_cast<long long>(chunks(Re)) * C * C;
  const long long wn = static_cast<long long>(chunks(Rn)) * Cin * 2 * C;
  long long part = stats > we ? stats : we;
  part = part > wn ? part : wn;
  long long tmp = static_cast<long long>(groups(tiles(Re))) * 2 * C;
  const long long t2 = static_cast<long long>(groups(chunks(Re))) * C * C;
  const long long t3 = static_cast<long long>(groups(chunks(Rn))) * Cin * 2 * C;
  tmp = tmp > t2 ? tmp : t2;
  tmp = tmp > t3 ? tmp : t3;
  out[0] = part;
  out[1] = tmp;
  return 0;
}

// Forward.  x [B*N][Cin]; w1 [Cin][2C] = [w1a - w1b | w1b]; w2, w3 [C][C];
// gamma, beta [3][C]; idx / smask [B*N*K]; cnt [B] (rows past it hold no
// real node); n_edges [1] double (the real slots).  Writes ap [B*N][2C], z
// [3][B*N*K][C] (each layer before its BatchNorm), y [B*N][C], inv_deg
// [B*N], and with train st [3][5][C] (s, t, mean, rstd, var per layer);
// without train st's rows s, t are the caller's.  part and tmp are scratch
// (pn_edge_scratch), sums [2C] double.
int pn_edge_fwd(const float* x, const float* w1, const float* w2,
                const float* w3, const float* gamma, const float* beta,
                const int* idx, const unsigned char* smask, const int* cnt,
                const double* n_edges, float* ap, float* z, float* st,
                float* y, float* inv_deg, float* part, double* tmp,
                double* sums, int B, int N, int K, int Cin, int C, int train,
                float eps, void* stream) {
  const cudaStream_t ss = static_cast<cudaStream_t>(stream);
  const int Re = B * N * K, Rn = B * N;
  const Rows er{cnt, N * K, K}, nr{cnt, N, 1};
  const size_t zs = static_cast<size_t>(Re) * C;
  float* stats = train ? part : nullptr;
  const float* ws[3] = {nullptr, w2, w3};

  PN_TRY(gemm(x, Cin, nullptr, nullptr, w1, ap, Rn, Cin, 2 * C, nr, nullptr,
              nullptr, ss));
  for (int l = 0; l < 3; ++l) {
    float* zl = z + l * zs;
    if (l == 0) {
      pn_edge_gather_kernel<<<tiles(Re), THREADS, 0, ss>>>(
          ap, idx, smask, zl, N, K, C, er, stats);
      PN_TRY(cudaGetLastError());
    } else {
      const float* sp = st + (l - 1) * 5 * C;
      PN_TRY(gemm(zl - zs, C, sp, sp + C, ws[l], zl, Re, C, C, er, smask,
                  stats, ss));
    }
    if (train) {
      PN_TRY(ordered_sum(part, tiles(Re), 2 * C, tmp, sums, nullptr, ss));
      pn_edge_affine_kernel<<<(C + 127) / 128, 128, 0, ss>>>(
          sums, n_edges, gamma + l * C, beta + l * C, eps, st + l * 5 * C, C);
      PN_TRY(cudaGetLastError());
    }
  }
  const int G = THREADS / C;
  pn_edge_mean_kernel<<<(Rn + G - 1) / G, THREADS, 0, ss>>>(
      z + 2 * zs, smask, st + 2 * 5 * C, st + 2 * 5 * C + C, cnt, y, inv_deg,
      N, K, C, Rn);
  return static_cast<int>(cudaGetLastError());
}

// Backward of pn_edge_fwd in training, from gy [B*N][C].  w1t [2C][Cin],
// w2t, w3t [C][C] are the weights transposed; order / offsets the reverse
// index of the lists.  Writes dx [B*N][Cin] (the caller zeroes it: rows of
// skipped tiles are left alone), dw1 [Cin][2C] (= x^T.[da | dp]), dw2,
// dw3, dgamma, dbeta [3][C].  g0, g1 [B*N*K][C], dap [B*N][2C], coef [2C],
// part, tmp and sums are scratch.
int pn_edge_bwd(const float* x, const float* w1t, const float* w2t,
                const float* w3t, const float* gamma, const int* idx,
                const unsigned char* smask, const int* cnt,
                const double* n_edges, const int* order, const int* offsets,
                const float* z, const float* st, const float* inv_deg,
                const float* gy, float* dx, float* dw1, float* dw2,
                float* dw3, float* dgamma, float* dbeta, float* g0,
                float* g1, float* dap, float* coef, float* part, double* tmp,
                double* sums, int B, int N, int K, int Cin, int C,
                void* stream) {
  const cudaStream_t ss = static_cast<cudaStream_t>(stream);
  const int Re = B * N * K, Rn = B * N;
  const Rows er{cnt, N * K, K}, nr{cnt, N, 1};
  const size_t zs = static_cast<size_t>(Re) * C;
  const float* wts[3] = {nullptr, w2t, w3t};
  float* dws[3] = {nullptr, dw2, dw3};
  float* bufs[2] = {g0, g1};

  // layer l's gradient arrives in bufs[l & 1] (the last layer's from gy);
  // its dz is written there, and dh of layer l - 1 into the other buffer
  for (int l = 2; l >= 0; --l) {
    const float* zl = z + l * zs;
    const float* sl = st + l * 5 * C;
    float* g = bufs[l & 1];
    const float* gin = l == 2 ? nullptr : g;
    pn_edge_bn_bwd_kernel<<<tiles(Re), THREADS, 0, ss>>>(
        zl, gin, gy, inv_deg, smask, sl, gamma + l * C, nullptr, nullptr, K,
        C, er, part);
    PN_TRY(cudaGetLastError());
    PN_TRY(ordered_sum(part, tiles(Re), 2 * C, tmp, sums, nullptr, ss));
    pn_edge_coef_kernel<<<(C + 127) / 128, 128, 0, ss>>>(
        sums, n_edges, coef, dgamma + l * C, dbeta + l * C, C);
    PN_TRY(cudaGetLastError());
    pn_edge_bn_bwd_kernel<<<tiles(Re), THREADS, 0, ss>>>(
        zl, gin, gy, inv_deg, smask, sl, gamma + l * C, coef, g, K, C, er,
        nullptr);
    PN_TRY(cudaGetLastError());
    if (l == 0) break;
    const float* sp = st + (l - 1) * 5 * C;
    PN_TRY(wgrad(zl - zs, C, sp, sp + C, g, C, dws[l], Re, C, C, er, part,
                 tmp, ss));
    PN_TRY(gemm(g, C, nullptr, nullptr, wts[l], bufs[(l - 1) & 1], Re, C, C,
                er, nullptr, nullptr, ss));
  }
  const int G = THREADS / C;
  pn_edge_node_grad_kernel<<<(Rn + G - 1) / G, THREADS, 0, ss>>>(
      g0, smask, order, offsets, cnt, dap, N, K, C, Rn);
  PN_TRY(cudaGetLastError());
  PN_TRY(gemm(dap, 2 * C, nullptr, nullptr, w1t, dx, Rn, 2 * C, Cin, nr,
              nullptr, nullptr, ss));
  PN_TRY(wgrad(x, Cin, nullptr, nullptr, dap, 2 * C, dw1, Rn, Cin, 2 * C, nr,
               part, tmp, ss));
  return 0;
}

}  // extern "C"
