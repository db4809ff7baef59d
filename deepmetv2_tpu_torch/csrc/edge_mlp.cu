// DRN edge-MLP EdgeConv, forward and backward, for Hopper (sm_90a).
//
// FORWARD.  Replaces the Pallas TPU kernel deepmetv2_tpu/ops/pallas/
// edge_mlp.py (_fwd_kernel, reached through edge_mlp_conv /
// _edge_stats_agg).  For the node term a [B,N,F1], features x [B,N,H],
// neighbour lists idx, mask [B,N,K], W_diff [H,F1], W1 [F1,H2] and b1
// [H2], each valid slot (i, k) with j = idx[b,i,k] carries the message
//
//   h = elu(elu(P_j + a_i) . W1 + b1),  P = x . W_diff    elu(z) = z > 0 ? z : exp(z) - 1
//
// and the kernel emits per node the sum of its messages (aggr add / mean)
// or their max and min (aggr max; -inf / +inf on a row with no valid
// slot), and the global statistics (sum h, sum h^2) over all valid edges.
// The BatchNorm affine around it stays in PyTorch (ops/edge_mlp.py:
// bn_combine).  The TPU kernel reads a pre-gathered [B,N,K,H] x_j and
// computes x_j . W_diff per edge; here the first layer is computed once
// per node (P, edge_mlp_proj_kernel) and its rows are gathered per edge.
//
// Design.  A block owns a group of NODES consecutive nodes of one event.
// It counts each node's valid slots and cuts the group into tiles of whole
// nodes with at most T = 128 valid slots each (a node never straddles two
// tiles; K <= T).  Per tile the slots are compacted into an edge list, the
// rows e0 = elu(P_j + a_i) are gathered into shared memory, and the second
// layer z1 = e0 . W1 is a register-tiled product (each thread 4 edges x
// 4*NH outputs, float4 loads of e0 and of W1 in shared memory).  The
// epilogue writes h to shared memory, and one thread per (node, output)
// folds the node's messages in ascending slot order.  Groups without a
// valid slot only write their rows' sentinels.
//
// Numbers: every entry of P and z1 is one fmaf chain over its inputs in
// ascending order from 0, z0 = P_j + a_i, and the node sums run in
// ascending slot order, exactly as the first design of this kernel (one
// warp per node, layer 1 per edge) did: agg0 and agg1 are its bits.  The
// statistics are per-thread partial sums, added across the block's threads
// and then across blocks in block order in double (ordered_sum_kernel), so
// two runs agree bit for bit (no atomics); in train mode the BatchNorm
// variance sum(h^2)/n - mean^2 cancels three digits at ckpts_syn_drn's
// weights, so the sums are kept to the f32 rounding of their value.  The
// plain version (torch.matmul, other orders) agrees to a tolerance
// (chip_smoke.py states it).
//
// What bounds it on the card: 2*H*F1 FP32 operations per node and 2*F1*H2
// per valid edge (about 8.5 GFLOP, 0.13 ms at 67 TFLOP/s, for the 659k
// edges of a B=40, N=2048 eval batch) against under 70 MB of inputs,
// outputs and P (0.02 ms at 3.35 TB/s): operations.
//
// BACKWARD.  Replaces the Pallas TPU kernel _bwd_kernel of the same file
// (reached through _esa_bwd, the custom VJP of _edge_stats_agg).  Given
// the forward's inputs, its agg0 / agg1 (max mode: the tie references),
// the cotangents g0, g1 [B,N,H2] of agg0, agg1 and gst [2,H2] of the
// statistics, each valid slot's message is recomputed and
//
//   dh   = max mode: [h == agg0] g0 / c0 + [h == agg1] g1 / c1, with c0, c1
//          the row's count of valid slots tied with agg0, agg1 (at least
//          1): a tie shares the cotangent evenly (the TPU kernel's rule)
//          sum mode:  g0
//        + gst0 + 2 h gst1
//   dz1  = dh elu'(z1),  dz0 = (dz1 . W1^T) elu'(z0)
//   da_i = sum over i's slots of dz0,   dW1 = sum e0^T dz1,  db1 = sum dz1
//
// over all valid edges.  The first layer is linear in x_j, so its
// gradients are per node: with D[j] = the sum of dz0 over the valid slots
// that gather row j (the gather's adjoint), dx = D . W_diff^T and dW_diff
// = X^T . D.
//
// Design.  The forward's blocks and tiles: a block owns a node group.  Per
// tile: recompute e0 and z1 (the forward's own operations, from the same
// P, so h is the forward's bit for bit and the tie tests are exact); one
// thread per (node, output) counts the node's ties and turns h into dh;
// dz1 = dh elu'(z1); dW1 and db1 accumulate in registers across the
// block's tiles (each thread 2 x 2 blocks of entries) and the block
// writes them once; de0 = dz1 . W1^T is a register-tiled product; elu'(z0)
// is gathered again into e0's buffer, dz0 = de0 elu'(z0) replaces it, da
// is its node sum in slot order, and each valid slot's dz0 row is written
// out.  edge_mlp_slot_sum_kernel sums those rows onto
// their sources through a reverse index (ascending (i, k)), giving D, and
// edge_mlp_node_bwd_kernel computes dx = D . W_diff^T and per block of
// nodes the partial X^T . D.  ordered_sum_kernel adds every partial in
// block order in double: no atomics, two runs agree bit for bit.
//
// What bounds it on the card: 6*H*F1 FP32 operations per node (P, dx,
// dW_diff) and 6*F1*H2 per valid edge (z1, de0, dW1): about 11 GFLOP,
// 0.17 ms at 67 TFLOP/s, for the 290k edges of a B=16, N=2048 train batch,
// against about 0.2 GB of dz0 rows written and read (0.07 ms): operations.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TX = 8;              // product threads along the columns
constexpr int TY = THREADS / TX;   // 32 along the rows
constexpr int RM = 4;              // rows per thread
constexpr int T = TY * RM;         // 128 rows per tile: edges, or nodes
constexpr int NODES = 32;          // nodes per group
constexpr int MAXD = 128;          // H, F1, H2 and K at most this
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(z) - 1.f;
}

__device__ __forceinline__ float delu(float z) {
  return z > 0.f ? 1.f : expf(z);
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row stride of a shared tile of up to np columns (np a multiple of 32): 4
// more, so that the four consecutive rows a warp reads at once start in
// different banks, and every row starts 16-byte aligned.
__host__ __device__ constexpr int pad_stride(int np) { return np + 4; }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[r][4u + q] += sum over k < kd of A[m][k] * Bm[k][n], with m = ty +
// TY r and n = 4 tx + 32 u + q: A [rows][sa] and Bm [kd][sb] in shared
// memory, row-major.  Each entry is one fmaf chain in ascending k.
template <int NU>
__device__ __forceinline__ void gemm_nn(const float* A, int sa, const float* Bm,
                                        int sb, int kd, int ty, int tx,
                                        float (&acc)[RM][4 * NU]) {
  int k = 0;
  for (; k + 4 <= kd; k += 4) {
    float4 av[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + (ty + TY * r) * sa + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 bv = *reinterpret_cast<const float4*>(
            Bm + (k + kk) * sb + 4 * tx + 32 * u);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float av_k = comp(av[r], kk);
          acc[r][4 * u + 0] = fmaf(av_k, bv.x, acc[r][4 * u + 0]);
          acc[r][4 * u + 1] = fmaf(av_k, bv.y, acc[r][4 * u + 1]);
          acc[r][4 * u + 2] = fmaf(av_k, bv.z, acc[r][4 * u + 2]);
          acc[r][4 * u + 3] = fmaf(av_k, bv.w, acc[r][4 * u + 3]);
        }
      }
    }
  }
  for (; k < kd; ++k) {
    float av[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = A[(ty + TY * r) * sa + k];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(Bm + k * sb + 4 * tx + 32 * u);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        acc[r][4 * u + 0] = fmaf(av[r], bv.x, acc[r][4 * u + 0]);
        acc[r][4 * u + 1] = fmaf(av[r], bv.y, acc[r][4 * u + 1]);
        acc[r][4 * u + 2] = fmaf(av[r], bv.z, acc[r][4 * u + 2]);
        acc[r][4 * u + 3] = fmaf(av[r], bv.w, acc[r][4 * u + 3]);
      }
    }
  }
}

// acc[r][v] += sum over k < kd of A[m][k] * Bt[n][k], with m = ty + TY r
// and n = tx + TX v: A [rows][sa] and Bt [cols][sb] in shared memory,
// row-major (both read along k).  Each entry one fmaf chain in ascending k.
template <int NV>
__device__ __forceinline__ void gemm_nt(const float* A, int sa, const float* Bt,
                                        int sb, int kd, int ty, int tx,
                                        float (&acc)[RM][NV]) {
  int k = 0;
  for (; k + 4 <= kd; k += 4) {
    float4 av[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + (ty + TY * r) * sa + k);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 bv =
          *reinterpret_cast<const float4*>(Bt + (tx + TX * v) * sb + k);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        acc[r][v] = fmaf(av[r].x, bv.x, acc[r][v]);
        acc[r][v] = fmaf(av[r].y, bv.y, acc[r][v]);
        acc[r][v] = fmaf(av[r].z, bv.z, acc[r][v]);
        acc[r][v] = fmaf(av[r].w, bv.w, acc[r][v]);
      }
    }
  }
  for (; k < kd; ++k) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float bv = Bt[(tx + TX * v) * sb + k];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        acc[r][v] = fmaf(A[(ty + TY * r) * sa + k], bv, acc[r][v]);
    }
  }
}

// ------------------------------------------------------------ node groups

// A group's plan, in shared memory: each node's valid slots, its tiles of
// whole nodes, and the current tile's edge list.
struct GroupMeta {
  int cnt[NODES];          // valid slots of each node
  int off[NODES];          // the node's first edge in its tile
  int tstart[NODES + 1];   // tile t holds nodes [tstart[t], tstart[t + 1])
  int ntiles;
  int total;               // valid slots of the group
  int tj[T];               // the tile's edges: source row,
  int tk[T];               // slot,
  unsigned char tn[T];     // node of the group
};

// gm.cnt for the group's nn nodes (rows m0 [nn][K] of the slot mask), one
// warp per node.
__device__ __forceinline__ void count_slots(const unsigned char* m0, int nn,
                                            int K, GroupMeta& gm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < nn; n += WARPS) {
    int c = 0;
    for (int k0 = 0; k0 < K; k0 += 32)
      c += __popc(__ballot_sync(
          FULL, k0 + lane < K && m0[static_cast<size_t>(n) * K + k0 + lane]));
    if (lane == 0) gm.cnt[n] = c;
  }
}

// Thread 0: cut the nn nodes into tiles of whole nodes, at most T valid
// slots each, in node order.
__device__ __forceinline__ void plan_tiles(int nn, GroupMeta& gm) {
  int t = 0, s = 0, tot = 0;
  gm.tstart[0] = 0;
  for (int n = 0; n < nn; ++n) {
    const int c = gm.cnt[n];
    if (s + c > T) {
      gm.tstart[++t] = n;
      s = 0;
    }
    gm.off[n] = s;
    s += c;
    tot += c;
  }
  gm.tstart[++t] = nn;
  gm.ntiles = t;
  gm.total = tot;
}

// Count, then plan: leaves gm ready for every thread.
__device__ __forceinline__ void plan_group(const unsigned char* m0, int nn,
                                           int K, GroupMeta& gm) {
  count_slots(m0, nn, K, gm);
  __syncthreads();
  if (threadIdx.x == 0) plan_tiles(nn, gm);
  __syncthreads();
}

__device__ __forceinline__ int tile_size(const GroupMeta& gm, int s1) {
  return gm.off[s1 - 1] + gm.cnt[s1 - 1];
}

// The edge list of the tile of nodes [s0, s1): each node's valid slots in
// ascending order from its offset (rows i0 [nn][K] of idx), one warp per
// node.
__device__ __forceinline__ void tile_edges(const int* i0,
                                           const unsigned char* m0, int s0,
                                           int s1, int K, GroupMeta& gm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = s0 + warp; n < s1; n += WARPS) {
    int base = gm.off[n];
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const size_t s = static_cast<size_t>(n) * K + k;
      const bool v = k < K && m0[s];
      const unsigned bits = __ballot_sync(FULL, v);
      if (v) {
        const int p = base + __popc(bits & ((1u << lane) - 1u));
        gm.tj[p] = i0[s];
        gm.tk[p] = k;
        gm.tn[p] = static_cast<unsigned char>(n);
      }
      base += __popc(bits);
    }
  }
}

// es[e][f] = elu(z0), or elu'(z0) with DERIV, z0 = P_j + a_i, for the
// tile's ne edges and f < F1s (P's row stride; its columns past F1 hold
// 0): Pb the event's P [N][F1s], a0 the group's rows of a [nn][F1].
// Consecutive threads read consecutive float4s of the P rows.
template <bool DERIV>
__device__ __forceinline__ void gather_z0(const float* __restrict__ Pb,
                                          const float* __restrict__ a0,
                                          const GroupMeta& gm, int ne, int F1,
                                          int F1s, float* es, int se) {
  const int f4n = F1s >> 2;
  for (int p = threadIdx.x; p < ne * f4n; p += THREADS) {
    const int e = p / f4n, c = (p - e * f4n) * 4;
    const float4 pv = __ldg(reinterpret_cast<const float4*>(
        Pb + static_cast<size_t>(gm.tj[e]) * F1s + c));
    const float* ar = a0 + static_cast<size_t>(gm.tn[e]) * F1;
    const float4 z = make_float4(pv.x + (c + 0 < F1 ? ar[c + 0] : 0.f),
                                 pv.y + (c + 1 < F1 ? ar[c + 1] : 0.f),
                                 pv.z + (c + 2 < F1 ? ar[c + 2] : 0.f),
                                 pv.w + (c + 3 < F1 ? ar[c + 3] : 0.f));
    *reinterpret_cast<float4*>(es + e * se + c) =
        DERIV ? make_float4(delu(z.x), delu(z.y), delu(z.z), delu(z.w))
              : make_float4(elu(z.x), elu(z.y), elu(z.z), elu(z.w));
  }
}

// --------------------------------------------------------------- forward

// P [rows][F1s] = x [rows][H] . W_diff [H][F1] (zero columns past F1): T
// rows per block, each entry one fmaf chain over c ascending from 0.
template <int NF>
__global__ void __launch_bounds__(THREADS)
edge_mlp_proj_kernel(const float* __restrict__ x, const float* __restrict__ wd,
                     float* __restrict__ P, int rows, int H, int F1, int F1s) {
  constexpr int SW = pad_stride(32 * NF);
  const int sx = pad_stride(round_up(H, 32));
  extern __shared__ float smem[];
  float* wds = smem;              // [H][SW]
  float* xs = wds + H * SW;       // [T][sx]
  const size_t r0 = static_cast<size_t>(blockIdx.x) * T;
  for (int p = threadIdx.x; p < H * SW; p += THREADS) {
    const int r = p / SW, c = p - r * SW;
    wds[p] = c < F1 ? wd[r * F1 + c] : 0.f;
  }
  for (int p = threadIdx.x; p < T * H; p += THREADS) {
    const int r = p / H, c = p - r * H;
    xs[r * sx + c] = r0 + r < static_cast<size_t>(rows) ? x[r0 * H + p] : 0.f;
  }
  __syncthreads();
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  float acc[RM][4 * NF];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NF; ++c) acc[r][c] = 0.f;
  gemm_nn<NF>(xs, sx, wds, SW, H, ty, tx, acc);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const size_t row = r0 + ty + TY * r;
    if (row >= static_cast<size_t>(rows)) continue;
#pragma unroll
    for (int u = 0; u < NF; ++u) {
      const int col = 4 * tx + 32 * u;
      if (col < F1s)
        *reinterpret_cast<float4*>(P + row * F1s + col) = make_float4(
            acc[r][4 * u], acc[r][4 * u + 1], acc[r][4 * u + 2],
            acc[r][4 * u + 3]);
    }
  }
}

size_t proj_smem(int H, int F1) {
  return sizeof(float) *
         (static_cast<size_t>(H) * pad_stride(round_up(F1, 32)) +
          static_cast<size_t>(T) * pad_stride(round_up(H, 32)));
}

// The row stride of the forward's tile: e0 rows (F1), then h rows (H2).
__host__ __device__ __forceinline__ int tile_stride(int F1, int H2) {
  const int se = pad_stride(round_up(F1, 32));
  const int sh = pad_stride(round_up(H2, 32));
  return se > sh ? se : sh;
}

size_t fwd_smem(int F1, int H2) {
  return sizeof(float) *
         (static_cast<size_t>(F1) * pad_stride(round_up(H2, 32)) +
          static_cast<size_t>(T) * tile_stride(F1, H2));
}

template <int NH>
__global__ void __launch_bounds__(THREADS)
edge_mlp_fwd_kernel(const float* __restrict__ P, const float* __restrict__ a,
                    const int* __restrict__ idx,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    float* __restrict__ agg0, float* __restrict__ agg1,
                    float* __restrict__ partial, int N, int K, int F1,
                    int F1s, int H2, int maxmode) {
  constexpr int H2p = 32 * NH;
  constexpr int SW = pad_stride(H2p);
  const int st = tile_stride(F1, H2);
  __shared__ GroupMeta gm;
  extern __shared__ float smem[];
  float* w1s = smem;               // [F1][SW]
  float* ts = w1s + F1 * SW;       // [T][st]: e0, then h

  const int b = blockIdx.y, n0 = blockIdx.x * NODES;
  const int nn = min(NODES, N - n0);
  const size_t row0 = static_cast<size_t>(b) * N + n0;
  const size_t blk = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  const float lo = maxmode ? -CUDART_INF_F : 0.f;
  plan_group(mask + row0 * K, nn, K, gm);
  if (gm.total == 0) {
    // no valid slot: the rows' sentinels, and no statistics
    for (int p = threadIdx.x; p < nn * H2; p += THREADS) {
      agg0[row0 * H2 + p] = lo;
      if (maxmode) agg1[row0 * H2 + p] = CUDART_INF_F;
    }
    for (int p = threadIdx.x; p < 2 * H2; p += THREADS)
      partial[blk * 2 * H2 + p] = 0.f;
    return;
  }
  for (int p = threadIdx.x; p < F1 * SW; p += THREADS) {
    const int r = p / SW, c = p - r * SW;
    w1s[p] = c < H2 ? w1[r * H2 + c] : 0.f;
  }
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  float bias[4 * NH], ps[4 * NH], pq[4 * NH];
#pragma unroll
  for (int c = 0; c < 4 * NH; ++c) {
    const int o = 4 * tx + 32 * (c >> 2) + (c & 3);
    bias[c] = o < H2 ? b1[o] : 0.f;
    ps[c] = pq[c] = 0.f;
  }
  const float* Pb = P + static_cast<size_t>(b) * N * F1s;
  const float* a0 = a + row0 * F1;
  for (int t = 0; t < gm.ntiles; ++t) {
    const int s0 = gm.tstart[t], s1 = gm.tstart[t + 1];
    const int ne = tile_size(gm, s1);   // > 0: the group has edges
    tile_edges(idx + row0 * K, mask + row0 * K, s0, s1, K, gm);
    __syncthreads();
    gather_z0<false>(Pb, a0, gm, ne, F1, F1s, ts, st);
    __syncthreads();
    // z1 = e0 . W1, then h = elu(z1 + b1) over the e0 rows
    float acc[RM][4 * NH];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4 * NH; ++c) acc[r][c] = 0.f;
    gemm_nn<NH>(ts, st, w1s, SW, F1, ty, tx, acc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = ty + TY * r;
#pragma unroll
      for (int c = 0; c < 4 * NH; ++c) {
        const float hv = elu(acc[r][c] + bias[c]);
        acc[r][c] = hv;
        if (m < ne) {
          ps[c] += hv;
          pq[c] += hv * hv;
        }
      }
#pragma unroll
      for (int u = 0; u < NH; ++u)
        *reinterpret_cast<float4*>(ts + m * st + 4 * tx + 32 * u) =
            make_float4(acc[r][4 * u], acc[r][4 * u + 1], acc[r][4 * u + 2],
                        acc[r][4 * u + 3]);
    }
    __syncthreads();
    // each (node, output): its messages folded in ascending slot order
    for (int p = threadIdx.x; p < (s1 - s0) * H2; p += THREADS) {
      const int n = s0 + p / H2, o = p % H2;
      const int e0 = gm.off[n], e1 = e0 + gm.cnt[n];
      float s = lo, s1v = CUDART_INF_F;
      for (int e = e0; e < e1; ++e) {
        const float hv = ts[e * st + o];
        if (maxmode) {
          s = fmaxf(s, hv);
          s1v = fminf(s1v, hv);
        } else {
          s += hv;
        }
      }
      agg0[(row0 + n) * H2 + o] = s;
      if (maxmode) agg1[(row0 + n) * H2 + o] = s1v;
    }
    __syncthreads();   // the next tile rewrites the edge list and the tile
  }

  // the block's statistics: the threads' partial sums added in double
  float* sums = ts;    // [TY][2][H2p]
#pragma unroll
  for (int c = 0; c < 4 * NH; ++c) {
    const int o = 4 * tx + 32 * (c >> 2) + (c & 3);
    sums[(ty * 2 + 0) * H2p + o] = ps[c];
    sums[(ty * 2 + 1) * H2p + o] = pq[c];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < 2 * H2; p += THREADS) {
    const int r = p / H2, o = p - r * H2;
    double s = 0.0;
    for (int y = 0; y < TY; ++y) s += sums[(y * 2 + r) * H2p + o];
    partial[blk * 2 * H2 + p] = static_cast<float>(s);
  }
}

// out[e] = the sum over blocks k < nblk of part[k * stride + off + e], e < n,
// in double and in block order: SUM_CHUNKS runs of consecutive blocks,
// each added in order by one thread, then the runs in order (a fixed
// grouping, so two runs agree bit for bit).  In double because the
// BatchNorm variance sum(h^2)/n - mean^2 cancels (to 1e-3 of mean^2 at
// ckpts_syn_drn's round 1) and the weight gradients sum 1e5-1e6 terms of
// either sign: the sums are kept to the f32 rounding of their value.
constexpr int SUM_COLS = 8;
constexpr int SUM_CHUNKS = THREADS / SUM_COLS;

__global__ void __launch_bounds__(THREADS)
ordered_sum_kernel(const float* __restrict__ part, int nblk, int stride,
                   int off, int n, float* __restrict__ out) {
  __shared__ double runs[SUM_CHUNKS][SUM_COLS];
  const int col = threadIdx.x % SUM_COLS, chunk = threadIdx.x / SUM_COLS;
  const int e = blockIdx.x * SUM_COLS + col;
  const int len = (nblk + SUM_CHUNKS - 1) / SUM_CHUNKS;
  const int k1 = min(nblk, (chunk + 1) * len);
  double s = 0.0;
  if (e < n)
    for (int k = chunk * len; k < k1; ++k)
      s += part[static_cast<size_t>(k) * stride + off + e];
  runs[chunk][col] = s;
  __syncthreads();
  if (chunk == 0 && e < n) {
    double t = 0.0;
    for (int c = 0; c < SUM_CHUNKS; ++c) t += runs[c][col];
    out[e] = static_cast<float>(t);
  }
}

cudaError_t ordered_sum(const float* part, int nblk, int stride, int off,
                        int n, float* out, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  ordered_sum_kernel<<<(n + SUM_COLS - 1) / SUM_COLS, THREADS, 0, s>>>(
      part, nblk, stride, off, n, out);
  return cudaGetLastError();
}

// -------------------------------------------------------------- backward

struct BwdArgs {
  const float* P;             // [B, N, F1s]
  const float* a;             // [B, N, F1]
  const int* idx;             // [B, N, K]
  const unsigned char* mask;  // [B, N, K]
  const float* w1;            // [F1, H2]
  const float* b1;            // [H2]
  const float* agg0;          // [B, N, H2]
  const float* agg1;          // max mode
  const float* g0;            // [B, N, H2]
  const float* g1;            // max mode
  const float* gst;           // [2, H2]
  float* da;                  // [B, N, F1]
  float* dz0;                 // [B, N, K, F1s], valid slots' rows only
  float* partial;             // [B * groups][F1 * H2 + H2]
  int N, K, F1, F1s, H2, maxmode;
};

template <int NF, int NH>
__global__ void __launch_bounds__(THREADS)
edge_mlp_bwd_kernel(const BwdArgs p) {
  constexpr int F1p = 32 * NF, H2p = 32 * NH;
  constexpr int SE = pad_stride(F1p), SW = pad_stride(H2p);
  __shared__ GroupMeta gm;
  extern __shared__ float smem[];
  float* w1s = smem;              // [F1p][SW], zero past F1 and H2
  float* es = w1s + F1p * SW;     // [T][SE]: e0, then dz0
  float* ds = es + T * SE;        // [T][SW]: h, dh, then dz1
  const int F1 = p.F1, F1s = p.F1s, H2 = p.H2, K = p.K, N = p.N;

  const int b = blockIdx.y, n0 = blockIdx.x * NODES;
  const int nn = min(NODES, N - n0);
  const size_t row0 = static_cast<size_t>(b) * N + n0;
  float* out = p.partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                               (F1 * H2 + H2);
  plan_group(p.mask + row0 * K, nn, K, gm);
  if (gm.total == 0) {
    // no valid slot: da is 0, and so are the weight-gradient partials
    for (int q = threadIdx.x; q < nn * F1; q += THREADS)
      p.da[row0 * F1 + q] = 0.f;
    for (int q = threadIdx.x; q < F1 * H2 + H2; q += THREADS) out[q] = 0.f;
    return;
  }
  for (int q = threadIdx.x; q < F1p * SW; q += THREADS) {
    const int r = q / SW, c = q - r * SW;
    w1s[q] = (r < F1 && c < H2) ? p.w1[r * H2 + c] : 0.f;
  }

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int tf = threadIdx.x >> 4, to = threadIdx.x & 15;   // dW1's grid
  float bias[4 * NH];
#pragma unroll
  for (int c = 0; c < 4 * NH; ++c) {
    const int o = 4 * tx + 32 * (c >> 2) + (c & 3);
    bias[c] = o < H2 ? p.b1[o] : 0.f;
  }
  // dW1[f][o], f = 2 tf + 32 i + (0, 1), o = 2 to + 32 j + (0, 1); db1[o]
  // (threads with tf = 0): the block's sums over all its tiles
  float aw[2 * NF][2 * NH], dbl[2 * NH];
#pragma unroll
  for (int i = 0; i < 2 * NF; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NH; ++j) aw[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NH; ++j) dbl[j] = 0.f;

  const float* Pb = p.P + static_cast<size_t>(b) * N * F1s;
  const float* a0 = p.a + row0 * F1;
  for (int t = 0; t < gm.ntiles; ++t) {
    const int s0 = gm.tstart[t], s1 = gm.tstart[t + 1];
    const int ne = tile_size(gm, s1);   // > 0: the group has edges
    tile_edges(p.idx + row0 * K, p.mask + row0 * K, s0, s1, K, gm);
    __syncthreads();
    gather_z0<false>(Pb, a0, gm, ne, F1, F1s, es, SE);
    __syncthreads();

    // z1 = e0 . W1 + b1 (the forward's operations), h = elu(z1)
    float z[RM][4 * NH];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4 * NH; ++c) z[r][c] = 0.f;
    gemm_nn<NH>(es, SE, w1s, SW, F1, ty, tx, z);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = ty + TY * r;
#pragma unroll
      for (int c = 0; c < 4 * NH; ++c) z[r][c] = z[r][c] + bias[c];
#pragma unroll
      for (int u = 0; u < NH; ++u)
        *reinterpret_cast<float4*>(ds + m * SW + 4 * tx + 32 * u) =
            make_float4(elu(z[r][4 * u]), elu(z[r][4 * u + 1]),
                        elu(z[r][4 * u + 2]), elu(z[r][4 * u + 3]));
    }
    __syncthreads();

    // each (node, output): dh over the node's slots, ties counted first
    for (int q = threadIdx.x; q < (s1 - s0) * H2; q += THREADS) {
      const int n = s0 + q / H2, o = q % H2;
      const int e0 = gm.off[n], e1 = e0 + gm.cnt[n];
      const size_t row = row0 + n;
      const float gs0 = p.gst[o], gs1 = p.gst[H2 + o];
      if (p.maxmode) {
        const float r0 = p.agg0[row * H2 + o], r1 = p.agg1[row * H2 + o];
        float c0 = 0.f, c1 = 0.f;
        for (int e = e0; e < e1; ++e) {
          const float hv = ds[e * SW + o];
          c0 += hv == r0 ? 1.f : 0.f;
          c1 += hv == r1 ? 1.f : 0.f;
        }
        const float q0 = p.g0[row * H2 + o] / fmaxf(c0, 1.f);
        const float q1 = p.g1[row * H2 + o] / fmaxf(c1, 1.f);
        for (int e = e0; e < e1; ++e) {
          const float hv = ds[e * SW + o];
          const float dh = (hv == r0 ? q0 : 0.f) + (hv == r1 ? q1 : 0.f);
          ds[e * SW + o] = dh + gs0 + 2.f * hv * gs1;
        }
      } else {
        const float q0 = p.g0[row * H2 + o];
        for (int e = e0; e < e1; ++e) {
          const float hv = ds[e * SW + o];
          ds[e * SW + o] = q0 + gs0 + 2.f * hv * gs1;
        }
      }
    }
    __syncthreads();

    // dz1 = dh elu'(z1), 0 on the rows past the tile's edges
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = ty + TY * r;
#pragma unroll
      for (int u = 0; u < NH; ++u) {
        float4* dp = reinterpret_cast<float4*>(ds + m * SW + 4 * tx + 32 * u);
        float4 d = *dp;
        d.x = m < ne ? d.x * delu(z[r][4 * u + 0]) : 0.f;
        d.y = m < ne ? d.y * delu(z[r][4 * u + 1]) : 0.f;
        d.z = m < ne ? d.z * delu(z[r][4 * u + 2]) : 0.f;
        d.w = m < ne ? d.w * delu(z[r][4 * u + 3]) : 0.f;
        *dp = d;
      }
    }
    __syncthreads();

    // dW1 += e0^T dz1 and db1 += dz1, over the tile's edges in order
    for (int e = 0; e < ne; ++e) {
      float2 ev[NF], dv[NH];
#pragma unroll
      for (int i = 0; i < NF; ++i)
        ev[i] = *reinterpret_cast<const float2*>(es + e * SE + 2 * tf + 32 * i);
#pragma unroll
      for (int j = 0; j < NH; ++j)
        dv[j] = *reinterpret_cast<const float2*>(ds + e * SW + 2 * to + 32 * j);
#pragma unroll
      for (int i = 0; i < NF; ++i)
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          aw[2 * i][2 * j] = fmaf(ev[i].x, dv[j].x, aw[2 * i][2 * j]);
          aw[2 * i][2 * j + 1] = fmaf(ev[i].x, dv[j].y, aw[2 * i][2 * j + 1]);
          aw[2 * i + 1][2 * j] = fmaf(ev[i].y, dv[j].x, aw[2 * i + 1][2 * j]);
          aw[2 * i + 1][2 * j + 1] =
              fmaf(ev[i].y, dv[j].y, aw[2 * i + 1][2 * j + 1]);
        }
      if (tf == 0) {
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          dbl[2 * j] += dv[j].x;
          dbl[2 * j + 1] += dv[j].y;
        }
      }
    }

    // de0 = dz1 . W1^T, then dz0 = de0 elu'(z0) into es
    float d[RM][4 * NF];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int v = 0; v < 4 * NF; ++v) d[r][v] = 0.f;
    gemm_nt<4 * NF>(ds, SW, w1s, SW, H2, ty, tx, d);
    __syncthreads();   // every thread is done with e0
    gather_z0<true>(Pb, a0, gm, ne, F1, F1s, es, SE);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = ty + TY * r;
#pragma unroll
      for (int v = 0; v < 4 * NF; ++v) {
        const int f = tx + TX * v;
        if (f < F1) es[m * SE + f] = d[r][v] * es[m * SE + f];
      }
    }
    __syncthreads();

    // da: each node's dz0 summed in slot order; each slot's dz0 row out
    for (int q = threadIdx.x; q < (s1 - s0) * F1; q += THREADS) {
      const int n = s0 + q / F1, f = q % F1;
      const int e0 = gm.off[n], e1 = e0 + gm.cnt[n];
      float s = 0.f;
      for (int e = e0; e < e1; ++e) s += es[e * SE + f];
      p.da[(row0 + n) * F1 + f] = s;
    }
    const int f4n = F1s >> 2;
    for (int q = threadIdx.x; q < ne * f4n; q += THREADS) {
      const int e = q / f4n, c = (q - e * f4n) * 4;
      const size_t slot = (row0 + gm.tn[e]) * K + gm.tk[e];
      *reinterpret_cast<float4*>(p.dz0 + slot * F1s + c) =
          *reinterpret_cast<const float4*>(es + e * SE + c);
    }
    __syncthreads();   // the next tile rewrites the edge list and tiles
  }

  // the block's partial sums: [dW1 (F1 * H2) | db1 (H2)]
#pragma unroll
  for (int i = 0; i < 2 * NF; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NH; ++j) {
      const int f = 2 * tf + 32 * (i >> 1) + (i & 1);
      const int o = 2 * to + 32 * (j >> 1) + (j & 1);
      if (f < F1 && o < H2) out[f * H2 + o] = aw[i][j];
    }
  if (tf == 0) {
#pragma unroll
    for (int j = 0; j < 2 * NH; ++j) {
      const int o = 2 * to + 32 * (j >> 1) + (j & 1);
      if (o < H2) out[F1 * H2 + o] = dbl[j];
    }
  }
}

size_t bwd_smem(int F1, int H2) {
  const int F1p = round_up(F1, 32), H2p = round_up(H2, 32);
  return sizeof(float) * (static_cast<size_t>(F1p) * pad_stride(H2p) +
                          static_cast<size_t>(T) * pad_stride(F1p) +
                          static_cast<size_t>(T) * pad_stride(H2p));
}

// out[b, j, :C] = the sum of the rows src[b, s, :C] (row stride cs) over
// the slots s = order[b, q] for q in [offsets[b, j], offsets[b, j + 1]),
// ascending (i, k): the gather's adjoint.  One warp per row, lane = column.
__global__ void __launch_bounds__(THREADS)
edge_mlp_slot_sum_kernel(const float* __restrict__ src,
                         const int* __restrict__ order,
                         const int* __restrict__ offsets,
                         float* __restrict__ out, int B, int N, int K, int C,
                         int cs) {
  const int lane = threadIdx.x & 31;
  const size_t r =
      static_cast<size_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= static_cast<size_t>(B) * N) return;
  const size_t b = r / N;
  const int j = static_cast<int>(r - b * N);
  const float* sb = src + b * N * K * cs;
  const int* ob = order + b * N * K;
  const int* off = offsets + b * (N + 1);
  float acc[MAXD / 32];
#pragma unroll
  for (int u = 0; u < MAXD / 32; ++u) acc[u] = 0.f;
  for (int q = off[j]; q < off[j + 1]; ++q) {
    const float* s = sb + static_cast<size_t>(ob[q]) * cs;
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < C) acc[u] += s[c];
    }
  }
#pragma unroll
  for (int u = 0; u < MAXD / 32; ++u) {
    const int c = lane + 32 * u;
    if (c < C) out[r * C + c] = acc[u];
  }
}

// Per block of T rows: dx = D . W_diff^T, and the block's partial
// X^T . D [H][F1] (each thread 2 x 2 blocks of entries, rows in order).
template <int NX, int NF>
__global__ void __launch_bounds__(THREADS)
edge_mlp_node_bwd_kernel(const float* __restrict__ D,
                         const float* __restrict__ x,
                         const float* __restrict__ wd, float* __restrict__ dx,
                         float* __restrict__ partial, int rows, int H, int F1) {
  constexpr int Hp = 32 * NX, F1p = 32 * NF;
  constexpr int SF = pad_stride(F1p), SX = pad_stride(Hp);
  extern __shared__ float smem[];
  float* wds = smem;            // [Hp][SF], zero past H and F1
  float* Ds = wds + Hp * SF;    // [T][SF]
  float* xs = Ds + T * SF;      // [T][SX]
  const size_t r0 = static_cast<size_t>(blockIdx.x) * T;
  const size_t left = static_cast<size_t>(rows) - r0;
  for (int q = threadIdx.x; q < Hp * SF; q += THREADS) {
    const int r = q / SF, c = q - r * SF;
    wds[q] = (r < H && c < F1) ? wd[r * F1 + c] : 0.f;
  }
  for (int q = threadIdx.x; q < T * F1p; q += THREADS) {
    const int r = q / F1p, c = q - r * F1p;
    Ds[r * SF + c] = (r < left && c < F1) ? D[(r0 + r) * F1 + c] : 0.f;
  }
  for (int q = threadIdx.x; q < T * Hp; q += THREADS) {
    const int r = q / Hp, c = q - r * Hp;
    xs[r * SX + c] = (r < left && c < H) ? x[(r0 + r) * H + c] : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  float acc[RM][4 * NX];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int v = 0; v < 4 * NX; ++v) acc[r][v] = 0.f;
  gemm_nt<4 * NX>(Ds, SF, wds, SF, F1, ty, tx, acc);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = ty + TY * r;
    if (m >= left) continue;
#pragma unroll
    for (int v = 0; v < 4 * NX; ++v) {
      const int c = tx + TX * v;
      if (c < H) dx[(r0 + m) * H + c] = acc[r][v];
    }
  }

  const int tc = threadIdx.x >> 4, tf = threadIdx.x & 15;
  float aw[2 * NX][2 * NF];
#pragma unroll
  for (int i = 0; i < 2 * NX; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) aw[i][j] = 0.f;
  for (int r = 0; r < T; ++r) {
    float2 xv[NX], dv[NF];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      xv[i] = *reinterpret_cast<const float2*>(xs + r * SX + 2 * tc + 32 * i);
#pragma unroll
    for (int j = 0; j < NF; ++j)
      dv[j] = *reinterpret_cast<const float2*>(Ds + r * SF + 2 * tf + 32 * j);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        aw[2 * i][2 * j] = fmaf(xv[i].x, dv[j].x, aw[2 * i][2 * j]);
        aw[2 * i][2 * j + 1] = fmaf(xv[i].x, dv[j].y, aw[2 * i][2 * j + 1]);
        aw[2 * i + 1][2 * j] = fmaf(xv[i].y, dv[j].x, aw[2 * i + 1][2 * j]);
        aw[2 * i + 1][2 * j + 1] =
            fmaf(xv[i].y, dv[j].y, aw[2 * i + 1][2 * j + 1]);
      }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * H * F1;
#pragma unroll
  for (int i = 0; i < 2 * NX; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
      const int c = 2 * tc + 32 * (i >> 1) + (i & 1);
      const int f = 2 * tf + 32 * (j >> 1) + (j & 1);
      if (c < H && f < F1) out[c * F1 + f] = aw[i][j];
    }
}

size_t node_smem(int H, int F1) {
  const int Hp = round_up(H, 32), F1p = round_up(F1, 32);
  return sizeof(float) * (static_cast<size_t>(Hp) * pad_stride(F1p) +
                          static_cast<size_t>(T) * pad_stride(F1p) +
                          static_cast<size_t>(T) * pad_stride(Hp));
}

// ------------------------------------------------------ the reverse index

// The transpose of the neighbour lists that edge_mlp_slot_sum_kernel reads
// (ops/edge_mlp.py:reverse_slots is its plain version): per event, the
// flat slots s = i*K + k of the valid slots, ordered by their target j and,
// within a target, ascending.  A stable counting sort: the slots are cut
// into chunks of RT; a chunk's per-target counts (shared-memory integer
// atomics: only their totals are used), their prefix over the chunks, the
// targets' offsets, then each chunk places its slots warp by warp, so a
// slot's place depends only on the slots before it.
constexpr int RT = 1024;   // threads of the reverse-index kernels, slots per chunk

// hist[b][c][j]: the valid slots of chunk c of event b that point at j.
__global__ void __launch_bounds__(RT)
rev_hist_kernel(const int* __restrict__ idx,
                const unsigned char* __restrict__ mask, int* __restrict__ hist,
                int N, int K) {
  extern __shared__ int cnt_s[];   // [N]
  const int b = blockIdx.y, c = blockIdx.x;
  for (int j = threadIdx.x; j < N; j += RT) cnt_s[j] = 0;
  __syncthreads();
  const size_t ns = static_cast<size_t>(N) * K;
  const size_t s = static_cast<size_t>(c) * RT + threadIdx.x;
  if (s < ns && mask[b * ns + s]) atomicAdd(&cnt_s[idx[b * ns + s]], 1);
  __syncthreads();
  int* out = hist + (static_cast<size_t>(b) * gridDim.x + c) * N;
  for (int j = threadIdx.x; j < N; j += RT) out[j] = cnt_s[j];
}

// hist[b][c][j] becomes the count of the chunks before c; cnt[b][j] the
// total, for each of the B*N targets.
__global__ void rev_chunk_scan_kernel(int* __restrict__ hist,
                                      int* __restrict__ cnt, int B, int N,
                                      int nc) {
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= static_cast<size_t>(B) * N) return;
  const size_t b = r / N, j = r - b * N;
  int s = 0;
  for (int c = 0; c < nc; ++c) {
    int* p = hist + (b * nc + c) * N + j;
    const int v = *p;
    *p = s;
    s += v;
  }
  cnt[r] = s;
}

// offsets[b][j] = the sum of cnt[b][j'] over j' < j, offsets[b][N] the
// event's valid slots; one block per event.
__global__ void __launch_bounds__(RT)
rev_offsets_kernel(const int* __restrict__ cnt, int* __restrict__ offsets,
                   int N) {
  __shared__ int part[RT];
  const int b = blockIdx.x, per = (N + RT - 1) / RT;
  const int j0 = min(N, static_cast<int>(threadIdx.x) * per);
  const int j1 = min(N, j0 + per);
  const int* cb = cnt + static_cast<size_t>(b) * N;
  int s = 0;
  for (int j = j0; j < j1; ++j) s += cb[j];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = 1; o < RT; o <<= 1) {   // inclusive scan of the parts
    const int v = threadIdx.x >= o ? part[threadIdx.x - o] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int* ob = offsets + static_cast<size_t>(b) * (N + 1);
  s = part[threadIdx.x] - s;   // exclusive
  for (int j = j0; j < j1; ++j) {
    ob[j] = s;
    s += cb[j];
  }
  if (threadIdx.x == RT - 1) ob[N] = part[RT - 1];
}

// order[b][offsets[b][j] + hist[b][c][j] + (the chunk's earlier slots at
// j)] = s, the chunk's warps in turn, each warp's lanes ranked within
// their target.
__global__ void __launch_bounds__(RT)
rev_fill_kernel(const int* __restrict__ idx,
                const unsigned char* __restrict__ mask,
                const int* __restrict__ hist, const int* __restrict__ offsets,
                int* __restrict__ order, int N, int K) {
  extern __shared__ int seen[];   // [N]: the chunk's slots placed so far
  const int b = blockIdx.y, c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < N; j += RT) seen[j] = 0;
  const size_t ns = static_cast<size_t>(N) * K;
  const size_t s = static_cast<size_t>(c) * RT + threadIdx.x;
  const bool valid = s < ns && mask[b * ns + s];
  const int j = valid ? idx[b * ns + s] : -1;
  const int base =
      valid ? offsets[static_cast<size_t>(b) * (N + 1) + j] +
                  hist[(static_cast<size_t>(b) * gridDim.x + c) * N + j]
            : 0;
  __syncthreads();
  for (int w = 0; w < RT / 32; ++w) {
    if (warp == w) {
      const unsigned grp = __match_any_sync(FULL, j);
      const int mine = valid ? seen[j] : 0;
      __syncwarp();
      if (valid) {
        order[b * ns + base + mine + __popc(grp & ((1u << lane) - 1u))] =
            static_cast<int>(s);
        if (lane == 31 - __clz(grp)) seen[j] = mine + __popc(grp);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ host

template <typename... P, typename... A>
cudaError_t run(void (*kern)(P...), dim3 grid, size_t smem, cudaStream_t s,
                A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

int n32(int d) { return (d + 31) / 32; }

int reverse_chunks(int N, int K) {
  return static_cast<int>((static_cast<size_t>(N) * K + RT - 1) / RT);
}

bool widths_ok(int H, int F1, int H2) {
  return H >= 1 && H <= MAXD && F1 >= 1 && F1 <= MAXD && H2 >= 1 &&
         H2 <= MAXD;
}

using ProjKern = void (*)(const float*, const float*, float*, int, int, int,
                          int);
const ProjKern kProj[4] = {edge_mlp_proj_kernel<1>, edge_mlp_proj_kernel<2>,
                               edge_mlp_proj_kernel<3>, edge_mlp_proj_kernel<4>};

cudaError_t launch_proj(const float* x, const float* wd, float* P, int rows,
                        int H, int F1, cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  return run(kProj[n32(F1) - 1], dim3((rows + T - 1) / T), proj_smem(H, F1),
             s, x, wd, P, rows, H, F1, round_up(F1, 4));
}

using FwdKern = void (*)(const float*, const float*, const int*,
                         const unsigned char*, const float*, const float*,
                         float*, float*, float*, int, int, int, int, int, int);
const FwdKern kFwd[4] = {edge_mlp_fwd_kernel<1>, edge_mlp_fwd_kernel<2>,
                             edge_mlp_fwd_kernel<3>, edge_mlp_fwd_kernel<4>};

using BwdKern = void (*)(const BwdArgs);
const BwdKern kBwd[4][4] = {
    {edge_mlp_bwd_kernel<1, 1>, edge_mlp_bwd_kernel<1, 2>,
     edge_mlp_bwd_kernel<1, 3>, edge_mlp_bwd_kernel<1, 4>},
    {edge_mlp_bwd_kernel<2, 1>, edge_mlp_bwd_kernel<2, 2>,
     edge_mlp_bwd_kernel<2, 3>, edge_mlp_bwd_kernel<2, 4>},
    {edge_mlp_bwd_kernel<3, 1>, edge_mlp_bwd_kernel<3, 2>,
     edge_mlp_bwd_kernel<3, 3>, edge_mlp_bwd_kernel<3, 4>},
    {edge_mlp_bwd_kernel<4, 1>, edge_mlp_bwd_kernel<4, 2>,
     edge_mlp_bwd_kernel<4, 3>, edge_mlp_bwd_kernel<4, 4>}};

using NodeKern = void (*)(const float*, const float*, const float*, float*,
                          float*, int, int, int);
const NodeKern kNode[4][4] = {
    {edge_mlp_node_bwd_kernel<1, 1>, edge_mlp_node_bwd_kernel<1, 2>,
     edge_mlp_node_bwd_kernel<1, 3>, edge_mlp_node_bwd_kernel<1, 4>},
    {edge_mlp_node_bwd_kernel<2, 1>, edge_mlp_node_bwd_kernel<2, 2>,
     edge_mlp_node_bwd_kernel<2, 3>, edge_mlp_node_bwd_kernel<2, 4>},
    {edge_mlp_node_bwd_kernel<3, 1>, edge_mlp_node_bwd_kernel<3, 2>,
     edge_mlp_node_bwd_kernel<3, 3>, edge_mlp_node_bwd_kernel<3, 4>},
    {edge_mlp_node_bwd_kernel<4, 1>, edge_mlp_node_bwd_kernel<4, 2>,
     edge_mlp_node_bwd_kernel<4, 3>, edge_mlp_node_bwd_kernel<4, 4>}};

cudaError_t launch_node(const float* D, const float* x, const float* wd,
                        float* dx, float* partial, int rows, int H, int F1,
                        cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  return run(kNode[n32(H) - 1][n32(F1) - 1], dim3((rows + T - 1) / T),
             node_smem(H, F1), s, D, x, wd, dx, partial, rows, H, F1);
}

}  // namespace

extern "C" {

// The scratch the callers allocate: out[0] = F1s, the row stride of P and
// of the per-slot dz0 rows; out[1] = the node groups, one block of each
// edge kernel per group (rows of the forward's statistics partials
// [.][2][H2] and of the backward's weight-gradient partials [.][F1*H2 +
// H2]); out[2] = the node blocks (rows of the dW_diff partials [.][H*F1]);
// out[3] = the reverse index's chunks per event.
int edge_mlp_layout(int B, int N, int K, int F1, int* out) {
  if (F1 < 1 || F1 > MAXD || B < 0 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = round_up(F1, 4);
  out[1] = B * ((N + NODES - 1) / NODES);
  out[2] = (B * N + T - 1) / T;
  out[3] = reverse_chunks(N, K);
  return 0;
}

// P [rows][F1s] = x [rows][H] . W_diff [H][F1], zero columns past F1.
int edge_mlp_proj(const float* x, const float* wd, float* P, int rows, int H,
                  int F1, void* stream) {
  if (!widths_ok(H, F1, 1)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_proj(x, wd, P, rows, H, F1, static_cast<cudaStream_t>(stream)));
}

// agg0 [B,N,H2] (sum, or max with maxmode), agg1 [B,N,H2] (min; maxmode
// only, else unused), stats [2,H2]; P [B,N,F1s] and partial
// [out[1]][2][H2] are scratch (edge_mlp_layout).
int edge_mlp_fwd(const float* a, const float* x, const int* idx,
                 const unsigned char* mask, const float* wd, const float* w1,
                 const float* b1, float* P, float* agg0, float* agg1,
                 float* partial, float* stats, int B, int N, int K, int H,
                 int F1, int H2, int maxmode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(H, F1, H2) || K < 1 || K > T || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = (N + NODES - 1) / NODES;
  cudaError_t err = launch_proj(x, wd, P, B * N, H, F1, s);
  if (err == cudaSuccess)
    err = run(kFwd[n32(H2) - 1], dim3(ng, B), fwd_smem(F1, H2), s, P, a, idx,
              mask, w1, b1, agg0, agg1, partial, N, K, F1, round_up(F1, 4),
              H2, maxmode);
  if (err == cudaSuccess)
    err = ordered_sum(partial, B * ng, 2 * H2, 0, 2 * H2, stats, s);
  return static_cast<int>(err);
}

// Gradients of edge_mlp_fwd: da [B,N,F1], dzs [B,N,F1] (each row's sum of
// dz0 over the valid slots that gather it), dx [B,N,H], dwd [H,F1], dw1
// [F1,H2], db1 [H2]; agg0 / agg1 are the forward's outputs (max mode: the
// tie references; agg1, g1 unused otherwise), g0 / g1 [B,N,H2] and gst
// [2,H2] the cotangents; order / offsets the reverse index of the valid
// slots (ops/edge_mlp.py:reverse_slots).  Scratch (edge_mlp_layout): P
// [B,N,F1s], dz0 [B,N,K,F1s], partial_e [out[1]][F1*H2 + H2], partial_n
// [out[2]][H*F1].
int edge_mlp_bwd(const float* a, const float* x, const int* idx,
                 const unsigned char* mask, const float* wd, const float* w1,
                 const float* b1, const float* agg0, const float* agg1,
                 const float* g0, const float* g1, const float* gst,
                 const int* order, const int* offsets, float* P, float* dz0,
                 float* partial_e, float* partial_n, float* da, float* dzs,
                 float* dx, float* dwd, float* dw1, float* db1, int B, int N,
                 int K, int H, int F1, int H2, int maxmode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(H, F1, H2) || K < 1 || K > T || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int F1s = round_up(F1, 4), rows = B * N;
  const int ng = (N + NODES - 1) / NODES;
  cudaError_t err = launch_proj(x, wd, P, rows, H, F1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs p{P,   a,    idx,  mask, w1,  b1,      agg0,
                  agg1, g0,  g1,   gst,  da,   dz0,    partial_e,
                  N,    K,   F1,   F1s,  H2,  maxmode};
  err = run(kBwd[n32(F1) - 1][n32(H2) - 1], dim3(ng, B), bwd_smem(F1, H2), s,
            p);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_mlp_slot_sum_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      dz0, order, offsets, dzs, B, N, K, F1, F1s);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_node(dzs, x, wd, dx, partial_n, rows, H, F1, s);
  const int we = F1 * H2 + H2;   // a row of the edge blocks' partials
  if (err == cudaSuccess)
    err = ordered_sum(partial_n, (rows + T - 1) / T, H * F1, 0, H * F1, dwd,
                      s);
  if (err == cudaSuccess)
    err = ordered_sum(partial_e, B * ng, we, 0, F1 * H2, dw1, s);
  if (err == cudaSuccess)
    err = ordered_sum(partial_e, B * ng, we, F1 * H2, H2, db1, s);
  return static_cast<int>(err);
}

// The per-node half of the backward alone: dx [rows,H] = dzs [rows,F1] .
// W_diff^T and dwd [H,F1] = x^T . dzs; partial_n [out[2]][H*F1] scratch.
int edge_mlp_node_grads(const float* dzs, const float* x, const float* wd,
                        float* dx, float* partial_n, float* dwd, int rows,
                        int H, int F1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(H, F1, 1) || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_node(dzs, x, wd, dx, partial_n, rows, H, F1, s);
  if (err == cudaSuccess)
    err = ordered_sum(partial_n, (rows + T - 1) / T, H * F1, 0, H * F1, dwd,
                      s);
  return static_cast<int>(err);
}

// The reverse index of the lists idx / mask [B,N,K] (reverse_slots):
// order [B,N*K] (the first offsets[b][N] entries of each event), offsets
// [B,N+1]; hist [B][out[3]][N] and cnt [B,N] are scratch.
int edge_mlp_reverse(const int* idx, const unsigned char* mask, int* hist,
                     int* cnt, int* order, int* offsets, int B, int N, int K,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || K <= 0 || N > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = reverse_chunks(N, K);
  const size_t smem = sizeof(int) * N;
  rev_hist_kernel<<<dim3(nc, B), RT, smem, s>>>(idx, mask, hist, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rev_chunk_scan_kernel<<<(B * N + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      hist, cnt, B, N, nc);
  rev_offsets_kernel<<<B, RT, 0, s>>>(cnt, offsets, N);
  rev_fill_kernel<<<dim3(nc, B), RT, smem, s>>>(idx, mask, hist, offsets,
                                                order, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
