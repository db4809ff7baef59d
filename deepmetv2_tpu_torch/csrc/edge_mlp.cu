// DRN edge-MLP EdgeConv forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepmetv2_tpu/ops/pallas/edge_mlp.py
// (_fwd_kernel, reached through edge_mlp_conv / _edge_stats_agg).  For the
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
//
// Numbers: the products run as FMAs in another order than the plain
// version's torch.matmul, so kernel and plain version agree to a tolerance
// (chip_smoke.py states it), not bit for bit.
//
// What bounds it on the card: 2*(H*F1 + F1*H2) FP32 operations per valid
// edge (24.6 kFLOP at H=64, F1=96, H2=64: about 0.7 ms at 67 TFLOP/s for
// the 2M edges of a B=40, N=2048 eval batch) against under 40 MB of
// inputs and outputs (12 us at 3.35 TB/s), so operations bound it.

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
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += st_s[(w * 2 + r) * H2p + o];
    partial[blk * 2 * H2 + e] = s;
  }
}

// stats[e] = sum of partial[blk][e] over blocks, in block order
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ stats, int nblk,
                                    int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += partial[static_cast<size_t>(k) * n + e];
  stats[e] = s;
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

}  // extern "C"
