// DRN edge-MLP EdgeConv, forward and backward, for Hopper (sm_90a).
//
// FORWARD.  Replaces the Pallas TPU kernel deepmetv2_tpu/ops/pallas/
// edge_mlp.py (_fwd_kernel, reached through edge_mlp_conv /
// _edge_stats_agg).  For the
// node term a [B,N,F1], features x [B,N,H], neighbour lists idx, mask
// [B,N,K], W_diff [H,F1], W1 [F1,H2] and b1 [H2], each valid slot (i, k)
// with j = idx[b,i,k] carries the message
//
//   h = elu(elu(x_j . W_diff + a_i) . W1 + b1)        elu(z) = z > 0 ? z : exp(z) - 1
//
// and the kernel emits per node the sum of its messages (aggr add / mean)
// or their max and min (aggr max; -inf / +inf on a row with no valid
// slot), and the global statistics (sum h, sum h^2) over all valid edges.
// The BatchNorm affine around it stays in PyTorch (ops/edge_mlp.py:
// bn_combine).  Unlike the TPU kernel, which reads a pre-gathered
// [B,N,K,H] x_j, this one gathers x_j itself: Hopper gathers rows freely,
// and x_j would be 671 MB at B=40, N=2048, K=32, H=64.
//
// Design.  A block owns NODES consecutive nodes of one event, a warp
// NODES/WARPS of them; W_diff and W1 sit in shared memory (zero-padded to
// whole warps of output columns).  Per node the warp walks the valid slots
// in ascending order, E at a time: it gathers their x_j rows into shared
// memory (feature-major, so the E values of one feature are two float4
// broadcasts), then lane l computes output columns l, l+32, ... of both
// layers for all E edges, an E-wide register tile per column, and folds
// the messages into its running sum (or max and min) and statistics.
// Masked slots and rows without a valid slot cost nothing.  The statistics
// cannot carry across blocks as on the TPU's sequential grid: each block
// writes its partial sums (warps added in order), and a second pass adds
// the partials in block order, so two runs agree bit for bit (no atomics).
// Both cross-warp and cross-block sums run in double: in train mode the
// BatchNorm variance Σh²/n − mean² cancels three digits at ckpts_syn_drn's
// weights, so the statistics are kept to the f32 rounding of their value.
//
// Numbers: the products run as FMAs in another order than the plain
// version's torch.matmul, so kernel and plain version agree to a tolerance
// (chip_smoke.py states it), not bit for bit.
//
// What bounds it on the card: 2*(H*F1 + F1*H2) FP32 operations per valid
// edge (24.6 kFLOP at H=64, F1=96, H2=64: about 0.7 ms at 67 TFLOP/s for
// the 2M edges of a B=40, N=2048 eval batch) against under 40 MB of
// inputs and outputs (12 us at 3.35 TB/s), so operations bound it.
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
//   da_i = sum over i's slots of dz0,   dx_j[slot] = dz0 . W_diff^T
//   dW1  = sum e0^T dz1,  db1 = sum dz1,  dW_diff = sum x_j^T dz0
//
// over all valid edges.  Then, as the TPU kernel's caller does with XLA's
// scatter-add, each slot's dx_j row is summed onto its source row
// (edge_mlp_dx below).
//
// Design.  The forward's block shape: a block owns NODES nodes of one
// event, a warp NODES/WARPS of them, and a warp takes its node's valid
// slots E at a time.  The messages are recomputed by the forward's own
// sequence of operations (the same FMAs in the same order), so h equals
// the forward's bit for bit and the tie test against agg0 / agg1 is exact;
// in max mode a first sweep over the row counts the ties.  The weight
// gradients are block-wide sums: the block runs in rounds, each warp
// leaves one tile (x_j, e0, dz1, dz0 of up to E edges) in shared memory,
// and after a barrier all 256 threads fold the 8 tiles, in warp order and
// edge order, into the dW_diff and dW1 entries each thread owns in
// registers.  At the end each block writes its partial sums (db1: the
// warps' sums, added in warp order) and a second pass adds the partials
// in block order: no atomics, and two runs agree bit for bit.
//
// The gather's adjoint (edge_mlp_dx): x_j's gradient is written per slot,
// dx_j [B,N,K,H].  The fused lists are not symmetric where a row is past
// its cap, so the mirror table cannot carry it in general: the wrapper
// builds a reverse index (a stable sort of the valid slots by target) and
// one warp per source row adds its incoming slots' rows in ascending
// (i, k) order.
//
// Numbers: the products and sums run in another order than the plain
// version's torch.matmul and reductions, so the two agree to a tolerance
// (chip_smoke.py states it).  What bounds it on the card: the forward's
// 2*(H*F1 + F1*H2) operations per valid edge are repeated, and the
// backward adds 4*(H*F1 + F1*H2) (de0, dx_j, dW1, dW_diff): 6*(H*F1 +
// F1*H2) FP32 operations per valid edge (74 kFLOP at H=64, F1=96, H2=64:
// 1.1 ms at 67 TFLOP/s per million edges) against the dx_j rows (268 MB at
// B=16, N=2048, K=32, H=64: 0.08 ms at 3.35 TB/s) and the node tensors, so
// operations bound it.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;
constexpr int NODES = 32;   // nodes per block
constexpr int E = 8;        // edges per register tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(z) - 1.f;
}

size_t smem_floats(int H, int F1p, int H2p) {
  return static_cast<size_t>(H) * F1p + static_cast<size_t>(F1p) * H2p +
         static_cast<size_t>(WARPS) * H * E +
         static_cast<size_t>(WARPS) * F1p * E + WARPS * 2 * H2p +
         WARPS * E /* slot lists, as int */;
}

template <int NF1, int NH2, bool MAXMODE>
__global__ void __launch_bounds__(WARPS * 32)
edge_mlp_fwd_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    const int* __restrict__ idx,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ wd, const float* __restrict__ w1,
                    const float* __restrict__ b1, float* __restrict__ agg0,
                    float* __restrict__ agg1, float* __restrict__ partial,
                    int N, int K, int H, int F1, int H2) {
  constexpr int F1p = NF1 * 32;
  constexpr int H2p = NH2 * 32;
  extern __shared__ float smem[];
  float* wd_s = smem;                          // [H][F1p]
  float* w1_s = wd_s + H * F1p;                // [F1p][H2p]
  float* xs_all = w1_s + F1p * H2p;            // [WARPS][H][E]
  float* es_all = xs_all + WARPS * H * E;      // [WARPS][F1p][E]
  float* st_s = es_all + WARPS * F1p * E;      // [WARPS][2][H2p]
  int* sl_all = reinterpret_cast<int*>(st_s + WARPS * 2 * H2p);  // [WARPS][E]

  for (int e = threadIdx.x; e < H * F1p; e += blockDim.x) {
    const int r = e / F1p, c = e - r * F1p;
    wd_s[e] = c < F1 ? wd[r * F1 + c] : 0.f;
  }
  for (int e = threadIdx.x; e < F1p * H2p; e += blockDim.x) {
    const int r = e / H2p, c = e - r * H2p;
    w1_s[e] = (r < F1 && c < H2) ? w1[r * H2 + c] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  float* xs = xs_all + warp * H * E;
  float* es = es_all + warp * F1p * E;
  int* sl = sl_all + warp * E;

  float b1r[NH2], ps[NH2], pq[NH2];
#pragma unroll
  for (int t = 0; t < NH2; ++t) {
    const int o = lane + 32 * t;
    b1r[t] = o < H2 ? b1[o] : 0.f;
    ps[t] = 0.f;
    pq[t] = 0.f;
  }

  for (int n = warp; n < NODES; n += WARPS) {
    const int i = blockIdx.x * NODES + n;
    if (i >= N) break;
    const size_t row = static_cast<size_t>(b) * N + i;
    const int* ir = idx + row * K;
    const unsigned char* mr = mask + row * K;
    const float* xb = x + static_cast<size_t>(b) * N * H;

    float ar[NF1];
#pragma unroll
    for (int t = 0; t < NF1; ++t) {
      const int f = lane + 32 * t;
      ar[t] = f < F1 ? a[row * F1 + f] : 0.f;
    }
    float s0[NH2], s1[NH2];
#pragma unroll
    for (int t = 0; t < NH2; ++t) {
      s0[t] = MAXMODE ? -CUDART_INF_F : 0.f;
      s1[t] = CUDART_INF_F;
    }

    int ne = 0;
    for (int w0 = 0; w0 < K; w0 += 32) {
      const bool v = (w0 + lane < K) && mr[w0 + lane];
      unsigned bits = __ballot_sync(FULL, v);
      while (bits || (ne > 0 && w0 + 32 >= K)) {
        if (bits) {
          const int s = __ffs(bits) - 1;
          bits &= bits - 1;
          if (lane == 0) sl[ne] = w0 + s;
          ++ne;
          if (ne < E && (bits || w0 + 32 < K)) continue;
        }
        // a tile of ne (1..E) valid slots: gather x_j rows, feature-major
        __syncwarp();
        for (int e = 0; e < E; ++e) {
          const float* xr = e < ne ? xb + static_cast<size_t>(ir[sl[e]]) * H
                                   : nullptr;
          for (int c = lane; c < H; c += 32) xs[c * E + e] = xr ? xr[c] : 0.f;
        }
        __syncwarp();
        // layer 1: z0 = x_j . W_diff + a_i, e0 = elu(z0)
        float acc[NF1][E];
#pragma unroll
        for (int t = 0; t < NF1; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[t][e] = 0.f;
        for (int c = 0; c < H; ++c) {
          const float4 xa = *reinterpret_cast<const float4*>(xs + c * E);
          const float4 xc = *reinterpret_cast<const float4*>(xs + c * E + 4);
          const float xv[E] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
          for (int t = 0; t < NF1; ++t) {
            const float w = wd_s[c * F1p + lane + 32 * t];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[t][e] = fmaf(xv[e], w, acc[t][e]);
          }
        }
#pragma unroll
        for (int t = 0; t < NF1; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e)
            es[(lane + 32 * t) * E + e] = elu(acc[t][e] + ar[t]);
        __syncwarp();
        // layer 2: z1 = e0 . W1 + b1, h = elu(z1); fold into the reductions
        float acc2[NH2][E];
#pragma unroll
        for (int t = 0; t < NH2; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) acc2[t][e] = 0.f;
        for (int f = 0; f < F1; ++f) {
          const float4 ea = *reinterpret_cast<const float4*>(es + f * E);
          const float4 ec = *reinterpret_cast<const float4*>(es + f * E + 4);
          const float ev[E] = {ea.x, ea.y, ea.z, ea.w, ec.x, ec.y, ec.z, ec.w};
#pragma unroll
          for (int t = 0; t < NH2; ++t) {
            const float w = w1_s[f * H2p + lane + 32 * t];
#pragma unroll
            for (int e = 0; e < E; ++e) acc2[t][e] = fmaf(ev[e], w, acc2[t][e]);
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e >= ne) break;
#pragma unroll
          for (int t = 0; t < NH2; ++t) {
            const float hv = elu(acc2[t][e] + b1r[t]);
            if (MAXMODE) {
              s0[t] = fmaxf(s0[t], hv);
              s1[t] = fminf(s1[t], hv);
            } else {
              s0[t] += hv;
            }
            ps[t] += hv;
            pq[t] += hv * hv;
          }
        }
        ne = 0;
        __syncwarp();   // the tile's shared rows are free again
      }
    }

#pragma unroll
    for (int t = 0; t < NH2; ++t) {
      const int o = lane + 32 * t;
      if (o < H2) {
        agg0[row * H2 + o] = s0[t];
        if (MAXMODE) agg1[row * H2 + o] = s1[t];
      }
    }
  }

  // the block's statistics: each warp's, added in warp order
#pragma unroll
  for (int t = 0; t < NH2; ++t) {
    st_s[(warp * 2 + 0) * H2p + lane + 32 * t] = ps[t];
    st_s[(warp * 2 + 1) * H2p + lane + 32 * t] = pq[t];
  }
  __syncthreads();
  const size_t blk = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int e = threadIdx.x; e < 2 * H2; e += blockDim.x) {
    const int r = e / H2, o = e - r * H2;
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += st_s[(w * 2 + r) * H2p + o];
    partial[blk * 2 * H2 + e] = static_cast<float>(s);
  }
}

// stats[e] = sum of partial[blk][e] over blocks, in block order, added in
// double: the BatchNorm variance Σh²/n − mean² cancels (to 1e-3 of mean²
// at ckpts_syn_drn's round 1), so the sums are kept to the f32 rounding of
// the result
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ stats, int nblk,
                                    int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int k = 0; k < nblk; ++k) s += partial[static_cast<size_t>(k) * n + e];
  stats[e] = static_cast<float>(s);
}

template <int NF1, int NH2, bool MAXMODE>
cudaError_t launch_fwd(const float* a, const float* x, const int* idx,
                       const unsigned char* mask, const float* wd,
                       const float* w1, const float* b1, float* agg0,
                       float* agg1, float* partial, int B, int N, int K,
                       int H, int F1, int H2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(H, NF1 * 32, NH2 * 32);
  auto kern = edge_mlp_fwd_kernel<NF1, NH2, MAXMODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + NODES - 1) / NODES, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(a, x, idx, mask, wd, w1, b1, agg0,
                                           agg1, partial, N, K, H, F1, H2);
  return cudaGetLastError();
}

template <int NF1, int NH2>
cudaError_t dispatch_mode(bool maxmode, const float* a, const float* x,
                          const int* idx, const unsigned char* mask,
                          const float* wd, const float* w1, const float* b1,
                          float* agg0, float* agg1, float* partial, int B,
                          int N, int K, int H, int F1, int H2,
                          cudaStream_t s) {
  return maxmode
             ? launch_fwd<NF1, NH2, true>(a, x, idx, mask, wd, w1, b1, agg0,
                                          agg1, partial, B, N, K, H, F1, H2, s)
             : launch_fwd<NF1, NH2, false>(a, x, idx, mask, wd, w1, b1, agg0,
                                           agg1, partial, B, N, K, H, F1, H2,
                                           s);
}

template <int NF1>
cudaError_t dispatch_h2(int nh2, bool maxmode, const float* a, const float* x,
                        const int* idx, const unsigned char* mask,
                        const float* wd, const float* w1, const float* b1,
                        float* agg0, float* agg1, float* partial, int B,
                        int N, int K, int H, int F1, int H2, cudaStream_t s) {
  switch (nh2) {
    case 1: return dispatch_mode<NF1, 1>(maxmode, a, x, idx, mask, wd, w1, b1,
                                         agg0, agg1, partial, B, N, K, H, F1,
                                         H2, s);
    case 2: return dispatch_mode<NF1, 2>(maxmode, a, x, idx, mask, wd, w1, b1,
                                         agg0, agg1, partial, B, N, K, H, F1,
                                         H2, s);
    case 3: return dispatch_mode<NF1, 3>(maxmode, a, x, idx, mask, wd, w1, b1,
                                         agg0, agg1, partial, B, N, K, H, F1,
                                         H2, s);
    case 4: return dispatch_mode<NF1, 4>(maxmode, a, x, idx, mask, wd, w1, b1,
                                         agg0, agg1, partial, B, N, K, H, F1,
                                         H2, s);
  }
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------- backward

constexpr int MAXH = 128;   // H, F1, H2 at most this
constexpr int NH = MAXH / 32;

__device__ __forceinline__ float delu(float z) {
  return z > 0.f ? 1.f : expf(z);
}

// The two weight tables with odd row strides, rounded up to whole float4s
// so that the tiles after them are 16-byte aligned.
__host__ __device__ __forceinline__ int weights_floats(int H, int F1p,
                                                       int H2p) {
  return (H * (F1p + 1) + F1p * (H2p + 1) + 3) & ~3;
}

size_t bwd_smem_floats(int H, int F1p, int H2p) {
  return static_cast<size_t>(weights_floats(H, F1p, H2p)) +    // W_diff, W1
         static_cast<size_t>(WARPS) * E * (H + 2 * F1p + H2p) +  // tiles
         static_cast<size_t>(WARPS) * H2p +              // db1 per warp
         WARPS * E + WARPS;                              // slots, tile sizes
}

// The forward's message recompute for one tile of ne (1..E) valid slots
// sl[0..ne) of row `row`: gathers x_j into xs [H][E], leaves z0 (= x_j .
// W_diff + a_i) and z1 (= e0 . W1 + b1) in registers and e0 in es [F1p][E].
// The operations and their order are the forward kernel's, so h =
// elu(z1) equals the forward's bit for bit.
template <int NF1, int NH2>
__device__ __forceinline__ void recompute(
    const float* __restrict__ xb, const int* __restrict__ ir, const int* sl,
    int ne, const float* wd_s, int swd, const float* w1_s, int sw1,
    const float (&ar)[NF1], const float (&b1r)[NH2], float* xs, float* es,
    int H, int F1, int lane, float (&z0)[NF1][E], float (&z1)[NH2][E]) {
  __syncwarp();
  for (int e = 0; e < E; ++e) {
    const float* xr = e < ne ? xb + static_cast<size_t>(ir[sl[e]]) * H
                             : nullptr;
    for (int c = lane; c < H; c += 32) xs[c * E + e] = xr ? xr[c] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < NF1; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) z0[t][e] = 0.f;
  for (int c = 0; c < H; ++c) {
    const float4 xa = *reinterpret_cast<const float4*>(xs + c * E);
    const float4 xc = *reinterpret_cast<const float4*>(xs + c * E + 4);
    const float xv[E] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
    for (int t = 0; t < NF1; ++t) {
      const float w = wd_s[c * swd + lane + 32 * t];
#pragma unroll
      for (int e = 0; e < E; ++e) z0[t][e] = fmaf(xv[e], w, z0[t][e]);
    }
  }
#pragma unroll
  for (int t = 0; t < NF1; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      z0[t][e] = z0[t][e] + ar[t];
      es[(lane + 32 * t) * E + e] = elu(z0[t][e]);
    }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < NH2; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) z1[t][e] = 0.f;
  for (int f = 0; f < F1; ++f) {
    const float4 ea = *reinterpret_cast<const float4*>(es + f * E);
    const float4 ec = *reinterpret_cast<const float4*>(es + f * E + 4);
    const float ev[E] = {ea.x, ea.y, ea.z, ea.w, ec.x, ec.y, ec.z, ec.w};
#pragma unroll
    for (int t = 0; t < NH2; ++t) {
      const float w = w1_s[f * sw1 + lane + 32 * t];
#pragma unroll
      for (int e = 0; e < E; ++e) z1[t][e] = fmaf(ev[e], w, z1[t][e]);
    }
  }
#pragma unroll
  for (int t = 0; t < NH2; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) z1[t][e] = z1[t][e] + b1r[t];
}

// The next up to E valid slots of the row from the cursor (w0, bits): the
// valid slots of slot chunk [w0, w0 + 32) not taken yet.  Returns their
// count; 0 when the row has none left.
__device__ __forceinline__ int next_slots(const unsigned char* mr, int K,
                                          int lane, int& w0, unsigned& bits,
                                          int* sl) {
  int ne = 0;
  while (ne < E) {
    if (bits) {
      const int s = __ffs(bits) - 1;
      bits &= bits - 1;
      if (lane == 0) sl[ne] = w0 + s;
      ++ne;
    } else {
      w0 += 32;
      if (w0 >= K) break;
      bits = __ballot_sync(FULL, w0 + lane < K && mr[w0 + lane]);
    }
  }
  __syncwarp();
  return ne;
}

template <int NF1, int NH2, bool MAXMODE>
__global__ void __launch_bounds__(WARPS * 32)
edge_mlp_bwd_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    const int* __restrict__ idx,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ wd, const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ agg0,
                    const float* __restrict__ agg1,
                    const float* __restrict__ g0,
                    const float* __restrict__ g1,
                    const float* __restrict__ gst, float* __restrict__ da,
                    float* __restrict__ dxj, float* __restrict__ partial,
                    int N, int K, int H, int F1, int H2) {
  constexpr int F1p = NF1 * 32;
  constexpr int H2p = NH2 * 32;
  constexpr int SWD = F1p + 1;   // odd row strides: conflict-free columns
  constexpr int SW1 = H2p + 1;
  constexpr int RI = 2 * NF1;    // dW1 rows (f) per thread
  constexpr int RO = 2 * NH2;    // dW1 columns (o) per thread
  constexpr int RC = MAXH / 16;  // dW_diff rows (c) per thread, at most
  extern __shared__ float smem[];
  float* wd_s = smem;                                  // [H][SWD]
  float* w1_s = wd_s + H * SWD;                        // [F1p][SW1]
  float* xs_all = smem + weights_floats(H, F1p, H2p);  // [WARPS][H][E]
  float* es_all = xs_all + WARPS * H * E;              // [WARPS][F1p][E]
  float* d1_all = es_all + WARPS * F1p * E;            // [WARPS][H2p][E]
  float* d0_all = d1_all + WARPS * H2p * E;            // [WARPS][F1p][E]
  float* db_s = d0_all + WARPS * F1p * E;              // [WARPS][H2p]
  int* sl_all = reinterpret_cast<int*>(db_s + WARPS * H2p);  // [WARPS][E]
  int* ne_s = sl_all + WARPS * E;                      // [WARPS]

  for (int e = threadIdx.x; e < H * SWD; e += blockDim.x) {
    const int r = e / SWD, c = e - r * SWD;
    wd_s[e] = c < F1 ? wd[r * F1 + c] : 0.f;
  }
  for (int e = threadIdx.x; e < F1p * SW1; e += blockDim.x) {
    const int r = e / SW1, c = e - r * SW1;
    w1_s[e] = (r < F1 && c < H2) ? w1[r * H2 + c] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  float* xs = xs_all + warp * H * E;
  float* es = es_all + warp * F1p * E;
  float* d1s = d1_all + warp * H2p * E;
  float* d0s = d0_all + warp * F1p * E;
  int* sl = sl_all + warp * E;
  const float* xb = x + static_cast<size_t>(b) * N * H;

  float b1r[NH2], gs0[NH2], gs1[NH2], dbl[NH2];
#pragma unroll
  for (int t = 0; t < NH2; ++t) {
    const int o = lane + 32 * t;
    b1r[t] = o < H2 ? b1[o] : 0.f;
    gs0[t] = o < H2 ? gst[o] : 0.f;
    gs1[t] = o < H2 ? gst[H2 + o] : 0.f;
    dbl[t] = 0.f;
  }
  // the weight-gradient entries this thread owns: dW1[f][o] with
  // f = ty + 16 i, o = tx + 16 j; dW_diff[c][f] with c = ty + 16 i,
  // f = tx + 16 j
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float aw1[RI][RO], awd[RC][RI];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) aw1[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) awd[i][j] = 0.f;

  // the current node's state
  int n = warp - WARPS;
  bool have = false;
  size_t row = 0;
  const int* ir = nullptr;
  const unsigned char* mr = nullptr;
  int w0 = 0;
  unsigned bits = 0;
  float ar[NF1], dar[NF1], q0[NH2], q1[NH2], r0[NH2], r1[NH2];

  for (;;) {
    // ---- this warp's next tile: the next valid slots of its node
    int ne = 0;
    while (true) {
      if (have) {
        ne = next_slots(mr, K, lane, w0, bits, sl);
        if (ne > 0) break;
#pragma unroll
        for (int t = 0; t < NF1; ++t) {
          const int f = lane + 32 * t;
          if (f < F1) da[row * F1 + f] = dar[t];
        }
        have = false;
      }
      n += WARPS;
      const int i = blockIdx.x * NODES + n;
      if (n >= NODES || i >= N) break;
      row = static_cast<size_t>(b) * N + i;
      ir = idx + row * K;
      mr = mask + row * K;
#pragma unroll
      for (int t = 0; t < NF1; ++t) {
        const int f = lane + 32 * t;
        ar[t] = f < F1 ? a[row * F1 + f] : 0.f;
        dar[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < NH2; ++t) {
        const int o = lane + 32 * t;
        q0[t] = o < H2 ? g0[row * H2 + o] : 0.f;
        q1[t] = (MAXMODE && o < H2) ? g1[row * H2 + o] : 0.f;
        r0[t] = (MAXMODE && o < H2) ? agg0[row * H2 + o] : 0.f;
        r1[t] = (MAXMODE && o < H2) ? agg1[row * H2 + o] : 0.f;
      }
      // masked slots' x_j gradient is 0
      for (int k = 0; k < K; ++k) {
        if (mr[k]) continue;
        float* o = dxj + (row * K + k) * H;
        for (int c = lane; c < H; c += 32) o[c] = 0.f;
      }
      if (MAXMODE) {
        // the row's ties with the forward's max and min, counted over
        // its valid slots; the cotangent is shared evenly among them
        float c0[NH2], c1[NH2];
#pragma unroll
        for (int t = 0; t < NH2; ++t) c0[t] = c1[t] = 0.f;
        int tw = -32;
        unsigned tb = 0;
        for (;;) {
          const int m = next_slots(mr, K, lane, tw, tb, sl);
          if (m == 0) break;
          float z0[NF1][E], z1[NH2][E];
          recompute<NF1, NH2>(xb, ir, sl, m, wd_s, SWD, w1_s, SW1, ar, b1r,
                              xs, es, H, F1, lane, z0, z1);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (e >= m) break;
#pragma unroll
            for (int t = 0; t < NH2; ++t) {
              const float hv = elu(z1[t][e]);
              c0[t] += hv == r0[t] ? 1.f : 0.f;
              c1[t] += hv == r1[t] ? 1.f : 0.f;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < NH2; ++t) {
          q0[t] = q0[t] / fmaxf(c0[t], 1.f);
          q1[t] = q1[t] / fmaxf(c1[t], 1.f);
        }
      }
      w0 = -32;
      bits = 0;
      have = true;
    }

    // ---- the tile's gradients
    if (ne > 0) {
      float z0[NF1][E], z1[NH2][E];
      recompute<NF1, NH2>(xb, ir, sl, ne, wd_s, SWD, w1_s, SW1, ar, b1r, xs,
                          es, H, F1, lane, z0, z1);
      // dz1 = dh elu'(z1), 0 on the tile's unused edges
#pragma unroll
      for (int t = 0; t < NH2; ++t)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float d = 0.f;
          if (e < ne) {
            const float hv = elu(z1[t][e]);
            float dh;
            if (MAXMODE) {
              dh = (hv == r0[t] ? q0[t] : 0.f) + (hv == r1[t] ? q1[t] : 0.f);
            } else {
              dh = q0[t];
            }
            dh = dh + gs0[t] + 2.f * hv * gs1[t];
            d = dh * delu(z1[t][e]);
            dbl[t] += d;
          }
          d1s[(lane + 32 * t) * E + e] = d;
        }
      __syncwarp();
      // dz0 = (dz1 . W1^T) elu'(z0)
      float d0[NF1][E];
#pragma unroll
      for (int t = 0; t < NF1; ++t)
#pragma unroll
        for (int e = 0; e < E; ++e) d0[t][e] = 0.f;
      for (int o = 0; o < H2; ++o) {
        const float4 va = *reinterpret_cast<const float4*>(d1s + o * E);
        const float4 vc = *reinterpret_cast<const float4*>(d1s + o * E + 4);
        const float dv[E] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int t = 0; t < NF1; ++t) {
          const float w = w1_s[(lane + 32 * t) * SW1 + o];
#pragma unroll
          for (int e = 0; e < E; ++e) d0[t][e] = fmaf(dv[e], w, d0[t][e]);
        }
      }
#pragma unroll
      for (int t = 0; t < NF1; ++t)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = d0[t][e] * delu(z0[t][e]);
          if (e < ne) dar[t] += d;
          d0s[(lane + 32 * t) * E + e] = d;
        }
      __syncwarp();
      // dx_j = dz0 . W_diff^T, one row per valid slot
      for (int c = lane; c < H; c += 32) {
        float acc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = 0.f;
        for (int f = 0; f < F1; ++f) {
          const float4 va = *reinterpret_cast<const float4*>(d0s + f * E);
          const float4 vc = *reinterpret_cast<const float4*>(d0s + f * E + 4);
          const float dv[E] = {va.x, va.y, va.z, va.w,
                               vc.x, vc.y, vc.z, vc.w};
          const float w = wd_s[c * SWD + f];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(dv[e], w, acc[e]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e < ne) dxj[(row * K + sl[e]) * H + c] = acc[e];
      }
    }
    if (lane == 0) ne_s[warp] = ne;

    // ---- the block's weight gradients: every warp's tile, in warp order
    if (!__syncthreads_or(ne > 0)) break;
    for (int w = 0; w < WARPS; ++w) {
      const int nw = ne_s[w];
      const float* xw = xs_all + w * H * E;
      const float* ew = es_all + w * F1p * E;
      const float* d1w = d1_all + w * H2p * E;
      const float* d0w = d0_all + w * F1p * E;
      for (int e = 0; e < nw; ++e) {
        float ev[RI], dv[RO], cv[RC], fv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) ev[i] = ew[(ty + 16 * i) * E + e];
#pragma unroll
        for (int j = 0; j < RO; ++j) dv[j] = d1w[(tx + 16 * j) * E + e];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RO; ++j) aw1[i][j] = fmaf(ev[i], dv[j], aw1[i][j]);
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          const int c = ty + 16 * i;
          cv[i] = c < H ? xw[c * E + e] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RI; ++j) fv[j] = d0w[(tx + 16 * j) * E + e];
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) awd[i][j] = fmaf(cv[i], fv[j], awd[i][j]);
      }
    }
    __syncthreads();
  }

  // ---- the block's partial sums: [dW_diff (H*F1) | dW1 (F1*H2) | db1]
  const size_t blk = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  float* out = partial + blk * (static_cast<size_t>(H) * F1 + F1 * H2 + H2);
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int c = ty + 16 * i, f = tx + 16 * j;
      if (c < H && f < F1) out[c * F1 + f] = awd[i][j];
    }
  float* ow1 = out + H * F1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int f = ty + 16 * i, o = tx + 16 * j;
      if (f < F1 && o < H2) ow1[f * H2 + o] = aw1[i][j];
    }
#pragma unroll
  for (int t = 0; t < NH2; ++t) db_s[warp * H2p + lane + 32 * t] = dbl[t];
  __syncthreads();
  for (int o = threadIdx.x; o < H2; o += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += db_s[w * H2p + o];
    ow1[F1 * H2 + o] = static_cast<float>(s);
  }
}

// The weight gradients: entry e of [dW_diff | dW1 | db1] is the sum of the
// blocks' partials, in block order, added in double (as the statistics).
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dwd,
                                    float* __restrict__ dw1,
                                    float* __restrict__ db1, int nblk, int n1,
                                    int n2, int n3) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n1 + n2 + n3;
  if (e >= n) return;
  double s = 0.0;
  for (int k = 0; k < nblk; ++k) s += partial[static_cast<size_t>(k) * n + e];
  const float v = static_cast<float>(s);
  if (e < n1) dwd[e] = v;
  else if (e < n1 + n2) dw1[e - n1] = v;
  else db1[e - n1 - n2] = v;
}

// dx[b,j,:] = the sum of dx_j over the valid slots that gather row j,
// which the reverse index lists in ascending (i, k).  One warp per row,
// lane = feature.
__global__ void __launch_bounds__(WARPS * 32)
edge_mlp_dx_kernel(const float* __restrict__ dxj, const int* __restrict__ order,
                   const int* __restrict__ offsets, float* __restrict__ dx,
                   int B, int N, int K, int H) {
  const int lane = threadIdx.x & 31;
  const size_t r = static_cast<size_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= static_cast<size_t>(B) * N) return;
  const size_t b = r / N;
  const int j = static_cast<int>(r - b * N);
  const float* db = dxj + b * N * K * H;
  const int* ob = order + b * N * K;
  const int* off = offsets + b * (N + 1);
  float acc[NH];
#pragma unroll
  for (int u = 0; u < NH; ++u) acc[u] = 0.f;
  for (int p = off[j]; p < off[j + 1]; ++p) {
    const float* src = db + static_cast<size_t>(ob[p]) * H;
#pragma unroll
    for (int u = 0; u < NH; ++u) {
      const int c = lane + 32 * u;
      if (c < H) acc[u] += src[c];
    }
  }
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    const int c = lane + 32 * u;
    if (c < H) dx[r * H + c] = acc[u];
  }
}

template <int NF1, int NH2, bool MAXMODE>
cudaError_t launch_bwd(const float* a, const float* x, const int* idx,
                       const unsigned char* mask, const float* wd,
                       const float* w1, const float* b1, const float* agg0,
                       const float* agg1, const float* g0, const float* g1,
                       const float* gst, float* da, float* dxj,
                       float* partial, int B, int N, int K, int H, int F1,
                       int H2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(H, NF1 * 32, NH2 * 32);
  auto kern = edge_mlp_bwd_kernel<NF1, NH2, MAXMODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + NODES - 1) / NODES, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(a, x, idx, mask, wd, w1, b1, agg0,
                                           agg1, g0, g1, gst, da, dxj, partial,
                                           N, K, H, F1, H2);
  return cudaGetLastError();
}

template <int NF1, int NH2>
cudaError_t bwd_mode(bool maxmode, const float* a, const float* x,
                     const int* idx, const unsigned char* mask,
                     const float* wd, const float* w1, const float* b1,
                     const float* agg0, const float* agg1, const float* g0,
                     const float* g1, const float* gst, float* da, float* dxj,
                     float* partial, int B, int N, int K, int H, int F1,
                     int H2, cudaStream_t s) {
  return maxmode
             ? launch_bwd<NF1, NH2, true>(a, x, idx, mask, wd, w1, b1, agg0,
                                          agg1, g0, g1, gst, da, dxj, partial,
                                          B, N, K, H, F1, H2, s)
             : launch_bwd<NF1, NH2, false>(a, x, idx, mask, wd, w1, b1, agg0,
                                           agg1, g0, g1, gst, da, dxj,
                                           partial, B, N, K, H, F1, H2, s);
}

template <int NF1>
cudaError_t bwd_h2(int nh2, bool maxmode, const float* a, const float* x,
                   const int* idx, const unsigned char* mask, const float* wd,
                   const float* w1, const float* b1, const float* agg0,
                   const float* agg1, const float* g0, const float* g1,
                   const float* gst, float* da, float* dxj, float* partial,
                   int B, int N, int K, int H, int F1, int H2,
                   cudaStream_t s) {
  switch (nh2) {
    case 1: return bwd_mode<NF1, 1>(maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                                    agg1, g0, g1, gst, da, dxj, partial, B, N,
                                    K, H, F1, H2, s);
    case 2: return bwd_mode<NF1, 2>(maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                                    agg1, g0, g1, gst, da, dxj, partial, B, N,
                                    K, H, F1, H2, s);
    case 3: return bwd_mode<NF1, 3>(maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                                    agg1, g0, g1, gst, da, dxj, partial, B, N,
                                    K, H, F1, H2, s);
    case 4: return bwd_mode<NF1, 4>(maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                                    agg1, g0, g1, gst, da, dxj, partial, B, N,
                                    K, H, F1, H2, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows of the statistics partials the caller allocates ([rows][2][H2]).
int edge_mlp_num_blocks(int B, int N) { return B * ((N + NODES - 1) / NODES); }

// agg0 [B,N,H2] (sum, or max with maxmode), agg1 [B,N,H2] (min; maxmode
// only, else unused), stats [2,H2]; partial is [num_blocks][2][H2] scratch.
int edge_mlp_fwd(const float* a, const float* x, const int* idx,
                 const unsigned char* mask, const float* wd, const float* w1,
                 const float* b1, float* agg0, float* agg1, float* partial,
                 float* stats, int B, int N, int K, int H, int F1, int H2,
                 int maxmode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || H > 128 || F1 < 1 || F1 > 128 || H2 < 1 || H2 > 128 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nf1 = (F1 + 31) / 32, nh2 = (H2 + 31) / 32;
  cudaError_t err = cudaErrorInvalidValue;
  switch (nf1) {
    case 1: err = dispatch_h2<1>(nh2, maxmode, a, x, idx, mask, wd, w1, b1,
                                 agg0, agg1, partial, B, N, K, H, F1, H2, s);
            break;
    case 2: err = dispatch_h2<2>(nh2, maxmode, a, x, idx, mask, wd, w1, b1,
                                 agg0, agg1, partial, B, N, K, H, F1, H2, s);
            break;
    case 3: err = dispatch_h2<3>(nh2, maxmode, a, x, idx, mask, wd, w1, b1,
                                 agg0, agg1, partial, B, N, K, H, F1, H2, s);
            break;
    case 4: err = dispatch_h2<4>(nh2, maxmode, a, x, idx, mask, wd, w1, b1,
                                 agg0, agg1, partial, B, N, K, H, F1, H2, s);
            break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 2 * H2;
  stats_reduce_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      partial, stats, edge_mlp_num_blocks(B, N), n);
  return static_cast<int>(cudaGetLastError());
}

// Gradients of edge_mlp_fwd: da [B,N,F1], dxj [B,N,K,H] (0 at masked
// slots), dwd [H,F1], dw1 [F1,H2], db1 [H2]; agg0 / agg1 are the forward's
// outputs (max mode: the tie references; agg1, g1 unused otherwise), g0 /
// g1 [B,N,H2] and gst [2,H2] the cotangents; partial is [num_blocks][H*F1
// + F1*H2 + H2] scratch.
int edge_mlp_bwd(const float* a, const float* x, const int* idx,
                 const unsigned char* mask, const float* wd, const float* w1,
                 const float* b1, const float* agg0, const float* agg1,
                 const float* g0, const float* g1, const float* gst,
                 float* da, float* dxj, float* dwd, float* dw1, float* db1,
                 float* partial, int B, int N, int K, int H, int F1, int H2,
                 int maxmode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || H > MAXH || F1 < 1 || F1 > MAXH || H2 < 1 || H2 > MAXH ||
      K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nf1 = (F1 + 31) / 32, nh2 = (H2 + 31) / 32;
  cudaError_t err = cudaErrorInvalidValue;
  switch (nf1) {
    case 1: err = bwd_h2<1>(nh2, maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                            agg1, g0, g1, gst, da, dxj, partial, B, N, K, H,
                            F1, H2, s);
            break;
    case 2: err = bwd_h2<2>(nh2, maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                            agg1, g0, g1, gst, da, dxj, partial, B, N, K, H,
                            F1, H2, s);
            break;
    case 3: err = bwd_h2<3>(nh2, maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                            agg1, g0, g1, gst, da, dxj, partial, B, N, K, H,
                            F1, H2, s);
            break;
    case 4: err = bwd_h2<4>(nh2, maxmode, a, x, idx, mask, wd, w1, b1, agg0,
                            agg1, g0, g1, gst, da, dxj, partial, B, N, K, H,
                            F1, H2, s);
            break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n1 = H * F1, n2 = F1 * H2, n = n1 + n2 + H2;
  wgrad_reduce_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      partial, dwd, dw1, db1, edge_mlp_num_blocks(B, N), n1, n2, H2);
  return static_cast<int>(cudaGetLastError());
}

// dx [B,N,H] from dxj [B,N,K,H] through the reverse index order [B,N*K] /
// offsets [B,N+1].
int edge_mlp_dx(const float* dxj, const int* order, const int* offsets,
                float* dx, int B, int N, int K, int H, void* stream) {
  if (H < 1 || H > MAXH) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return 0;
  const size_t rows = static_cast<size_t>(B) * N;
  edge_mlp_dx_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      dxj, order, offsets, dx, B, N, K, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
