// The DRN's list matching for Hopper (sm_90a): normalized-cut weights on
// each row's neighbour list and the handshake rounds on them.
//
// Replaces no TPU kernel.  The JAX package's list matching
// (deepmetv2_tpu/ops/coarsen.py: normalized_cut_weights and
// handshake_matching) is XLA ops, and so was the port's
// (ops/coarsen.py, the plain version the CPU takes): the weights gathered
// every listed neighbour's feature row into a [B, N, cap, H] tensor (2.7 GB
// at B=40, N=8192, cap=32, H=64) and subtracted, squared and summed it in
// three more full passes; each handshake round was about a dozen launches
// over [B, N, cap].  For h [B,N,H] f32, the lists idx [B,N,cap] int32 with
// their slot mask [B,N,cap] and the node mask [B,N] (bool bytes):
//
//   deg_i    = max(number of valid slots of row i, 1)
//   w[i, s]  = sqrt(sum_f (h_i,f - h_j,f)^2) * (1/deg_i + 1/deg_j),
//              j = idx[i, s]; -inf at invalid slots
//   rounds:  every unmatched real node proposes to its heaviest valid,
//            unmatched listed neighbour (the first slot among equal
//            weights; no proposal if that weight is -inf or a candidate's
//            is NaN, as torch's amax / argmax on the plain version give);
//            mutual proposals match.
//   partner  = the matched node, or the node itself (unmatched, padded);
//   cluster  = min(i, partner); both int64 [B,N].
//
// Given the same weights, (cluster, partner) equal the plain
// handshake_matching's bit for bit.  The weights differ from the plain
// version's only in the order of the sum over f (a fixed tree here,
// torch's reduction there).  A listed index outside [0, N) counts as an
// invalid slot (the plain version's gather would fault).
//
// What bounds it on the card: bytes.  The inputs once and the outputs once
// are (4H + 5cap + 17) bytes a row: 142 MB at B=40, N=8192, cap=32, H=64,
// 42 us at 3.35 TB/s; the arithmetic, 3H operations a valid slot, is a few
// us.  The weights pass through device memory once (4cap bytes a row,
// written once, read by each round's live rows), and each listed
// neighbour's row of h is read from L2 (an event's h is <= 5000 x 256 B).
//
// Design: three kernels (the weights' call launches the first two), all
// on the caller's stream, with no host sync, no allocation and no atomics,
// so the results are the same bit for bit from call to call and under
// CUDA-graph replay:
//  - cut_degree_kernel: one thread a row, ivd = 1 / deg (IEEE division,
//    as torch's).
//  - cut_weights_kernel: one half-warp a row, 16 rows a block.  A row with
//    no valid slot writes -inf and leaves without reading h.  Lane l keeps
//    features l, l+16, ... of h_i in registers and slots l, l+16, ...; the
//    half-warp walks the valid slots two at a time (both neighbour rows'
//    loads in flight), each lane summing its features' squared differences
//    by FMA in ascending order, then a butterfly over the 16 lanes.  IEEE
//    addition is commutative, so every lane of a butterfly ends with the
//    same bits: the sum is one fixed tree.  Each load of a neighbour row
//    reads 64 contiguous bytes (16 lanes, 4 bytes each).
//  - handshake_kernel: one block of 512 threads an event, all rounds in
//    it.  `matched` (a byte a node: 0 unmatched, 1 padded, 2 matched by a
//    round) and `prop` (an int a node) live in shared memory, 5N bytes.
//    Propose: a thread a row, 512 rows of the event at a time; each
//    unmatched row loads its slots 32 at a time (16-byte loads of the
//    weights and lists, 4-byte loads of the mask, where cap is a multiple
//    of 4), all in flight at once, and keeps its first strict maximum over
//    the candidates.  Accept: a thread a row, prop[prop[i]] == i.  A
//    matched row keeps its partner in prop and skips later rounds, so its
//    slots are read no more.  B blocks use B of the 132 SMs (40 at
//    drn-infer's batch).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int MAX_N = 32768;    // nodes an event: 5N bytes of shared memory
constexpr int MAX_CAP = 128;    // slots a row: the kNN kernels' largest cap
constexpr int MAX_H = 256;      // features: sixteen a lane in the weights
constexpr int DEG_THREADS = 256;
constexpr int WT_THREADS = 256;  // 16 rows a block, a half-warp a row
constexpr int HS_THREADS = 512;  // a row a thread, 128 registers at most
constexpr int CH = 32;           // slots a thread holds at once

__global__ void __launch_bounds__(DEG_THREADS)
cut_degree_kernel(const unsigned char* __restrict__ nmask,
                  float* __restrict__ ivd, int64_t rows, int cap) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * DEG_THREADS +
                      threadIdx.x;
  if (row >= rows) return;
  const unsigned char* mr = nmask + row * cap;
  int deg = 0;
  for (int s = 0; s < cap; ++s) deg += mr[s] != 0;
  ivd[row] = __fdiv_rn(1.0f, fmaxf(static_cast<float>(deg), 1.0f));
}

// The lane's part of |h_i - h_j|^2: its features f = l + 16k (k < K,
// K = ceil(H / 16) rounded up to 4, 8 or 16) in ascending order, each
// squared difference added by one FMA.
template <int K>
__device__ __forceinline__ float lane_part(const float* xi,
                                           const float* __restrict__ hj,
                                           int l, int H) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = l + 16 * k;
    if (f < H) {
      const float d = __fsub_rn(xi[k], __ldg(hj + f));
      acc = __fmaf_rn(d, d, acc);
    }
  }
  return acc;
}

// The sum over the half-warp's 16 lanes, the same bits in every lane.
__device__ __forceinline__ float half_sum(float v, unsigned half) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(half, v, off, 16));
  return v;
}

template <int K>
__global__ void __launch_bounds__(WT_THREADS)
cut_weights_kernel(const float* __restrict__ h, const int* __restrict__ idx,
                   const unsigned char* __restrict__ nmask,
                   const float* __restrict__ ivd, float* __restrict__ w,
                   int64_t rows, int N, int H, int cap) {
  const int l = threadIdx.x & 15;
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (WT_THREADS / 16) +
                      (threadIdx.x >> 4);
  if (row >= rows) return;          // whole half-warps leave together
  const int64_t ev = row / N * N;   // the event's first row
  const int* ir = idx + row * cap;
  const unsigned char* mr = nmask + row * cap;
  float* wr = w + row * cap;

  bool any = false;
  for (int s = l; s < cap; s += 16) any |= mr[s] != 0;
  if (!__any_sync(half, any)) {
    for (int s = l; s < cap; s += 16) wr[s] = -CUDART_INF_F;
    return;
  }
  float xi[K];
  const float* hi = h + row * H;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = l + 16 * k;
    xi[k] = f < H ? __ldg(hi + f) : 0.0f;
  }
  const float* hb = h + ev * H;
  const float ivi = ivd[row];

  for (int s0 = 0; s0 < cap; s0 += 16) {
    const int s = s0 + l;
    int j = 0;
    bool valid = false;
    if (s < cap) {
      j = ir[s];
      valid = mr[s] != 0 &&
              static_cast<unsigned>(j) < static_cast<unsigned>(N);
    }
    unsigned todo = __ballot_sync(half, valid) >> (threadIdx.x & 16);
    float d2 = 0.0f;
    while (todo) {                  // todo is the same in every lane
      const int t0 = __ffs(todo) - 1;
      todo &= todo - 1;
      const int t1 = todo ? __ffs(todo) - 1 : t0;
      todo &= todo - 1;
      const int j0 = __shfl_sync(half, j, t0, 16);
      const int j1 = __shfl_sync(half, j, t1, 16);
      const float a0 =
          lane_part<K>(xi, hb + static_cast<int64_t>(j0) * H, l, H);
      const float a1 =
          lane_part<K>(xi, hb + static_cast<int64_t>(j1) * H, l, H);
      const float s0sum = half_sum(a0, half);
      const float s1sum = half_sum(a1, half);
      if (l == t0) d2 = s0sum;
      if (l == t1) d2 = s1sum;
    }
    if (s < cap)
      wr[s] = valid ? __fmul_rn(__fsqrt_rn(d2), __fadd_rn(ivi, ivd[ev + j]))
                    : -CUDART_INF_F;
  }
}

// Up to CH slots of a row from its weights, lists and slot mask: with
// VEC (cap a multiple of 4, rows 16-byte aligned) by 16-byte loads of the
// weights and lists and 4-byte loads of the mask, else slot by slot.
// Slots at or past n read as invalid.
template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ w,
                                           const int* __restrict__ idx,
                                           const unsigned char* __restrict__ m,
                                           int n, float* wv, int* jv,
                                           bool* mv) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < CH / 4; ++q) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      int4 b = make_int4(0, 0, 0, 0);
      unsigned c = 0;
      if (4 * q < n) {
        a = __ldg(reinterpret_cast<const float4*>(w) + q);
        b = __ldg(reinterpret_cast<const int4*>(idx) + q);
        c = __ldg(reinterpret_cast<const unsigned*>(m) + q);
      }
      wv[4 * q] = a.x;
      wv[4 * q + 1] = a.y;
      wv[4 * q + 2] = a.z;
      wv[4 * q + 3] = a.w;
      jv[4 * q] = b.x;
      jv[4 * q + 1] = b.y;
      jv[4 * q + 2] = b.z;
      jv[4 * q + 3] = b.w;
#pragma unroll
      for (int t = 0; t < 4; ++t) mv[4 * q + t] = (c >> (8 * t)) & 0xffu;
    }
  } else {
#pragma unroll
    for (int s = 0; s < CH; ++s) {
      const bool in = s < n;
      wv[s] = in ? __ldg(w + s) : 0.f;
      jv[s] = in ? __ldg(idx + s) : 0;
      mv[s] = in && __ldg(m + s) != 0;
    }
  }
}

// One block an event, all rounds; VEC as for load_chunk.
template <bool VEC>
__global__ void __launch_bounds__(HS_THREADS)
handshake_kernel(const float* __restrict__ w, const int* __restrict__ idx,
                 const unsigned char* __restrict__ nmask,
                 const unsigned char* __restrict__ node_mask,
                 long long* __restrict__ cluster,
                 long long* __restrict__ partner, int N, int cap,
                 int rounds) {
  extern __shared__ int4 smem[];
  int* prop = reinterpret_cast<int*>(smem);
  unsigned char* matched = reinterpret_cast<unsigned char*>(prop + N);
  const int64_t ev = static_cast<int64_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += HS_THREADS) {
    matched[i] = node_mask[ev + i] ? 0 : 1;
    prop[i] = i;
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    // propose: the first strict maximum over the row's candidates
    for (int i = threadIdx.x; i < N; i += HS_THREADS) {
      if (matched[i] != 0) continue;
      const int64_t e0 = (ev + i) * cap;
      float best = -CUDART_INF_F;
      int p = i;
      bool nan = false;
      for (int c0 = 0; c0 < cap; c0 += CH) {
        float wv[CH];
        int jv[CH];
        bool mv[CH];
        load_chunk<VEC>(w + e0 + c0, idx + e0 + c0, nmask + e0 + c0,
                        cap - c0, wv, jv, mv);
#pragma unroll
        for (int s = 0; s < CH; ++s) {
          const int j = jv[s];
          if (mv[s] && static_cast<unsigned>(j) < static_cast<unsigned>(N) &&
              matched[j] == 0) {
            const float x = wv[s];
            if (x != x) {
              nan = true;
            } else if (x > best) {
              best = x;
              p = j;
            }
          }
        }
      }
      prop[i] = !nan && best > -CUDART_INF_F ? p : i;
    }
    __syncthreads();
    // accept: mutual proposals
    for (int i = threadIdx.x; i < N; i += HS_THREADS) {
      if (matched[i] != 0) continue;
      const int p = prop[i];
      if (p != i && prop[p] == i) matched[i] = 2;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < N; i += HS_THREADS) {
    const int p = matched[i] == 2 ? prop[i] : i;
    partner[ev + i] = p;
    cluster[ev + i] = p < i ? p : i;
  }
}

bool valid_shape(int B, int N, int cap) {
  return B >= 0 && N >= 1 && N <= MAX_N && cap >= 1 && cap <= MAX_CAP;
}

cudaError_t weights(const float* h, const int* idx,
                    const unsigned char* nmask, float* ivd, float* w, int B,
                    int N, int H, int cap, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(B) * N;
  cut_degree_kernel<<<(rows + DEG_THREADS - 1) / DEG_THREADS, DEG_THREADS, 0,
                      st>>>(nmask, ivd, rows, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t per = WT_THREADS / 16;
  const dim3 grid((rows + per - 1) / per);
  if (H <= 64)
    cut_weights_kernel<4><<<grid, WT_THREADS, 0, st>>>(h, idx, nmask, ivd, w,
                                                       rows, N, H, cap);
  else if (H <= 128)
    cut_weights_kernel<8><<<grid, WT_THREADS, 0, st>>>(h, idx, nmask, ivd, w,
                                                       rows, N, H, cap);
  else
    cut_weights_kernel<16><<<grid, WT_THREADS, 0, st>>>(h, idx, nmask, ivd,
                                                        w, rows, N, H, cap);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t handshake_v(const float* w, const int* idx,
                        const unsigned char* nmask,
                        const unsigned char* node_mask, long long* cluster,
                        long long* partner, int B, int N, int cap, int rounds,
                        cudaStream_t st) {
  const size_t smem = static_cast<size_t>(N) * (sizeof(int) + 1);
  const cudaError_t err = cudaFuncSetAttribute(
      handshake_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  handshake_kernel<VEC><<<B, HS_THREADS, smem, st>>>(
      w, idx, nmask, node_mask, cluster, partner, N, cap, rounds);
  return cudaGetLastError();
}

cudaError_t handshake(const float* w, const int* idx,
                      const unsigned char* nmask,
                      const unsigned char* node_mask, long long* cluster,
                      long long* partner, int B, int N, int cap, int rounds,
                      cudaStream_t st) {
  const bool vec = cap % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(nmask) % 4 == 0;
  return (vec ? handshake_v<true> : handshake_v<false>)(
      w, idx, nmask, node_mask, cluster, partner, B, N, cap, rounds, st);
}

}  // namespace

extern "C" {

// w [B,N,cap] from h [B,N,H], idx [B,N,cap] and the slot mask nmask
// [B,N,cap]; ivd [B,N] is scratch (1 / deg).  N <= 32768, cap <= 128,
// H <= 256.
int cut_weights(const float* h, const int* idx, const unsigned char* nmask,
                float* ivd, float* w, int B, int N, int H, int cap,
                void* stream) {
  if (!valid_shape(B, N, cap) || H < 1 || H > MAX_H)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  return static_cast<int>(weights(h, idx, nmask, ivd, w, B, N, H, cap,
                                  static_cast<cudaStream_t>(stream)));
}

// cluster, partner [B,N] int64 from the weights w [B,N,cap], the lists and
// the node mask node_mask [B,N], after `rounds` handshake rounds.
int cut_handshake(const float* w, const int* idx, const unsigned char* nmask,
                  const unsigned char* node_mask, long long* cluster,
                  long long* partner, int B, int N, int cap, int rounds,
                  void* stream) {
  if (!valid_shape(B, N, cap) || rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  return static_cast<int>(handshake(w, idx, nmask, node_mask, cluster,
                                    partner, B, N, cap, rounds,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
