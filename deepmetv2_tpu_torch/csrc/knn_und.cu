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
//                with `directed` (a runtime flag): d2 <= t_i alone (each
//                source's threshold is staged as -1), so with cap = k each
//                real row lists its k nearest real sources;
//                idx/d2v  = the first cap members of row i in ascending
//                           (d2, j) order (0 / +inf where the row runs dry);
//                rel[b,i,j] = U(i,j) as a byte (optional)
//   padded query rows (mask false): t = +inf, every slot 0 / +inf, rel 0.
//
// sq and dot are summed over h in ascending order with __fmul_rn/__fadd_rn
// (never contracted into an FMA), and sq_i + sq_j is commutative, so d2 is
// symmetric bit for bit, t_i is exactly one of the values the extraction
// compares against it, and both kernels equal the plain PyTorch version
// (ops/knn_und.py) bit for bit.  That contract keeps the tensor cores out:
// TF32 ties the k-th distance (the JAX package measured it on about 25 % of
// nodes), and a split-f32 product on mma/wgmma sums in an order no plain
// version repeats.  So the products stay FP32 on the CUDA cores.
//
// Design.  Only real rows against real sources are computed, for any mask:
//  - knn_compact_kernel (one block per event) writes perm[b]: the event's
//    valid node ids ascending, then its padded ids ascending, and cnt[b],
//    the count of valid ones.  With a prefix mask perm is the identity.
//    Both kernels run it first; knn_kth also runs knn_sqnorm_kernel.
//  - A block owns R (<= 8, even) consecutive entries of perm, one warp per
//    query row.  A block past the event's count writes the padded-row
//    outputs and exits; so does each warp of a padded row.
//  - The block walks the event's real sources in 64-row chunks, gathered
//    through perm into shared memory by cp.async, double-buffered (chunk
//    c+1 is in flight while chunk c is computed).  Rows are padded to a
//    stride of an odd count of 16-byte words, so a warp's float4 loads of
//    consecutive source rows are free of bank conflicts.  Each thread
//    computes a 2 x 1 register tile (two query rows against one source) by
//    float4 loads: three shared loads per eight products, not two per one.
//  - Each warp keeps its query's masked d2 row over the real sources (in
//    perm order, i.e. ascending j) in shared memory.  knn_kth selects from
//    it by k rounds of a warp-wide argmin over per-lane minima (only the
//    winning lane rescans its share).  knn_extract compacts the row's
//    relation members into a list of (d2 bits, position) keys by ballots
//    and ranks them (keys are distinct, so rank = slot); a hub with more
//    than LIST members falls back to cap argmin rounds over the row.  The
//    relation rows are zeroed by 16-byte stores and each member's byte is
//    set where its pair is computed.  Every output has one writer; no
//    float atomics.
//
// What bounds it on the card: the distance products the data needs, one
// per pair of real nodes of an event, each pair once (d2 is symmetric):
// H*n*(n-1) FP32 operations per event of n real nodes, against the bytes of
// h and the outputs, with the extraction's B*N*N relation bytes (168 MB at
// B=40, N=2048: 0.05 ms at 3.35 TB/s) the largest; chip_smoke.py computes
// both from its data.  The kernels still compute each unordered pair twice
// (once per row), spend a multiply and an add on each product (half the FMA
// rate), and are held by the distance block (every 8-row block gathers all
// of its event's real source rows from L2, and the products' shared loads)
// and then by knn_kth's argmin rounds: times, and their split by
// probes/knn_breakdown.py, in PERF.md.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int CHUNK = 64;                  // real sources staged per step
constexpr int MAX_ROWS = 8;                // query rows (warps) per block
constexpr int ROW_BUDGET = 64 * 1024;      // bytes of d2 rows per block
constexpr int LIST = 64;                   // relation members ranked per row
constexpr int COMPACT_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// The most query rows, even and at least 2, whose d2 rows fit ROW_BUDGET.
// Two blocks then fit an SM at N = 2048 and H = 64.
int rows_per_block(int N) {
  int r = MAX_ROWS;
  while (r > 2 && static_cast<size_t>(r) * N * sizeof(float) > ROW_BUDGET)
    r -= 2;
  return r;
}

// Features rounded up to whole float4s (the pad columns hold zeros, which
// add +0 to a dot product and so leave d2 bit for bit as it was).
__host__ __device__ int padded_h(int H) { return (H + 3) & ~3; }

// Row stride of staged features: an odd count of 16-byte words, so eight
// consecutive rows' float4s land in eight distinct bank groups.
__host__ __device__ int row_stride(int H) {
  const int hp = padded_h(H);
  return ((hp / 4) % 2) ? hp : hp + 4;
}

struct Layout {  // byte offsets into dynamic shared memory
  size_t q, src, rows, sq, tj, ids, total;
};

// lists [R][LIST] u64 (extraction only), q [R][hs], src [2][CHUNK][hs],
// rows [R][N], then per buffer the chunk's sq, t and ids [2][CHUNK] each.
__host__ __device__ Layout layout(bool extract, int R, int N, int H) {
  const size_t hs = row_stride(H);
  Layout l;
  l.q = extract ? sizeof(unsigned long long) * R * LIST : 0;
  l.src = l.q + sizeof(float) * R * hs;
  l.rows = l.src + sizeof(float) * 2 * CHUNK * hs;
  l.sq = l.rows + sizeof(float) * static_cast<size_t>(R) * N;
  l.tj = l.sq + sizeof(float) * 2 * CHUNK;
  l.ids = l.tj + sizeof(float) * 2 * CHUNK;
  l.total = l.ids + sizeof(int) * 2 * CHUNK;
  return l;
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

// Per event: perm[b] = valid ids ascending, then padded ids ascending;
// cnt[b] = the count of valid ones.  A stable partition by ballots.
__global__ void __launch_bounds__(COMPACT_THREADS)
knn_compact_kernel(const unsigned char* __restrict__ mask,
                   int* __restrict__ perm, int* __restrict__ cnt, int N) {
  __shared__ int part[COMPACT_THREADS / 32];
  __shared__ int total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned char* m = mask + static_cast<size_t>(blockIdx.x) * N;
  int* pb = perm + static_cast<size_t>(blockIdx.x) * N;

  int c = 0;
  for (int j = tid; j < N; j += COMPACT_THREADS) c += m[j] != 0;
#pragma unroll
  for (int off = 16; off; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
  if (tid == 0) total = 0;
  __syncthreads();
  if (lane == 0) atomicAdd(&total, c);  // integers: the order is immaterial
  __syncthreads();
  const int n = total;

  int run = 0;  // valid ids before this step's
  for (int base = 0; base < N; base += COMPACT_THREADS) {
    const int j = base + tid;
    const bool f = j < N && m[j] != 0;
    const unsigned bal = __ballot_sync(FULL, f);
    if (lane == 0) part[warp] = __popc(bal);
    __syncthreads();
    int before = run + __popc(bal & ((1u << lane) - 1u));
    int all = 0;
    for (int w = 0; w < COMPACT_THREADS / 32; ++w) {
      const int pc = part[w];
      if (w < warp) before += pc;
      all += pc;
    }
    // a padded id has j - before padded ids ahead of it
    if (j < N) pb[f ? before : n + (j - before)] = j;
    run += all;
    __syncthreads();  // part[] is rewritten next step
  }
  if (tid == 0) cnt[blockIdx.x] = n;
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

// The smallest (value, index) of this lane's share of row[0, n) (entries
// lane, lane+32, ...); (+inf, n) when the share holds no finite value.
__device__ __forceinline__ void share_min(const float* row, int n, int lane,
                                          float& v, int& p) {
  v = CUDART_INF_F;
  p = n;
  for (int j = lane; j < n; j += 32) {
    const float x = row[j];
    if (x < v) {
      v = x;
      p = j;
    }
  }
}

// Up to `rounds` rounds, each handing the row's smallest (value, index) to
// emit(round, value, index) and removing it, until the row runs dry.  Only
// the lane that owns the winner rescans its share.  Returns the rounds
// taken.
template <class Emit>
__device__ int select_smallest(float* row, int n, int lane, int rounds,
                               Emit emit) {
  float lv;
  int lp;
  share_min(row, n, lane, lv, lp);
  int c = 0;
  for (; c < rounds; ++c) {
    float m = lv;
    int bi = lp;
    warp_argmin(m, bi);
    if (!(m < CUDART_INF_F)) break;  // dry
    emit(c, m, bi);
    if ((bi & 31) == lane) {
      row[bi] = CUDART_INF_F;
      share_min(row, n, lane, lv, lp);
    }
  }
  return c;
}

template <bool EXTRACT>
__global__ void __launch_bounds__(MAX_ROWS * 32, 2)
knn_kernel(const float* __restrict__ h, const float* __restrict__ sq,
           const float* __restrict__ t_in, const int* __restrict__ perm,
           const int* __restrict__ cnt, float* __restrict__ t_out,
           int* __restrict__ idx_out, float* __restrict__ d2v_out,
           unsigned char* __restrict__ rel_out, int N, int H,
           int kc /* k, or cap; negated: the directed extraction */) {
  bool directed = false;  // knn_kth's code stays as it was
  if constexpr (EXTRACT) {
    directed = kc < 0;
    kc = directed ? -kc : kc;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = blockDim.x >> 5;
  const int hs = row_stride(H), hp = padded_h(H);
  const Layout L = layout(EXTRACT, R, N, H);
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* src_s = reinterpret_cast<float*>(smem + L.src);
  float* rows = reinterpret_cast<float*>(smem + L.rows);
  float* sq_s = reinterpret_cast<float*>(smem + L.sq);
  float* tj_s = reinterpret_cast<float*>(smem + L.tj);
  int* id_s = reinterpret_cast<int*>(smem + L.ids);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t eb = static_cast<size_t>(blockIdx.y) * N;
  const int* pe = perm + eb;
  const float* hb = h + eb * H;
  const int n = cnt[blockIdx.y];
  const int p0 = blockIdx.x * R;

  auto pad_row = [&](int p) {  // the defined outputs of a padded query row
    const size_t i = eb + pe[p];
    if (!EXTRACT) {
      if (lane == 0) t_out[i] = CUDART_INF_F;
      return;
    }
    for (int c = lane; c < kc; c += 32) {
      idx_out[i * kc + c] = 0;
      d2v_out[i * kc + c] = CUDART_INF_F;
    }
  };

  if (EXTRACT && rel_out) {  // every relation row of the block starts at 0
    if (N % 16 == 0) {
      const int w16 = N / 16;
      for (int e = tid; e < R * w16; e += blockDim.x) {
        const int r = e / w16;
        if (p0 + r < N)
          reinterpret_cast<uint4*>(rel_out + (eb + pe[p0 + r]) * N)
              [e - r * w16] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < R * N; e += blockDim.x) {
        const int r = e / N;
        if (p0 + r < N) rel_out[(eb + pe[p0 + r]) * N + (e - r * N)] = 0;
      }
    }
  }
  if (p0 >= n) {  // padded query rows only: no distances
    if (p0 + warp < N) pad_row(p0 + warp);
    return;
  }
  const int nq = min(R, n - p0);  // real query rows of this block

  for (int e = tid; e < R * hp; e += blockDim.x) {
    const int r = e / hp, c = e - r * hp;
    q_s[r * hs + c] = (r < nq && c < H)
                          ? hb[static_cast<size_t>(pe[p0 + r]) * H + c]
                          : 0.f;
  }
  if (hp > H) {  // the pad columns of both source buffers, once
    const int w = hp - H;
    for (int e = tid; e < 2 * CHUNK * w; e += blockDim.x)
      src_s[(e / w) * hs + H + e % w] = 0.f;
  }

  // this thread's 2 x 1 tile: query rows qa, qb against source sl
  const int qa = 2 * (tid >> 6), qb = qa + 1, sl = tid & 63;
  const bool la = qa < nq, lb = qb < nq;
  const int ia = la ? pe[p0 + qa] : 0, ib = lb ? pe[p0 + qb] : 0;
  const float sqa = la ? sq[eb + ia] : 0.f, sqb = lb ? sq[eb + ib] : 0.f;
  const float ta = (EXTRACT && la) ? t_in[eb + ia] : 0.f;
  const float tb = (EXTRACT && lb) ? t_in[eb + ib] : 0.f;
  unsigned char* rela =
      (EXTRACT && rel_out && la) ? rel_out + (eb + ia) * N : nullptr;
  unsigned char* relb =
      (EXTRACT && rel_out && lb) ? rel_out + (eb + ib) * N : nullptr;

  auto stage = [&](int c) {  // chunk c of the real sources into buffer c&1
    const int s0 = c * CHUNK, rc = min(CHUNK, n - s0);
    float* buf = src_s + (c & 1) * CHUNK * hs;
    if ((H & 3) == 0) {
      const int hv = H >> 2;
      for (int e = tid; e < rc * hv; e += blockDim.x) {
        const int r = e / hv, v = e - r * hv;
        __pipeline_memcpy_async(
            buf + r * hs + 4 * v,
            hb + static_cast<size_t>(pe[s0 + r]) * H + 4 * v, 16);
      }
    } else {
      for (int e = tid; e < rc * H; e += blockDim.x) {
        const int r = e / H, v = e - r * H;
        __pipeline_memcpy_async(
            buf + r * hs + v, hb + static_cast<size_t>(pe[s0 + r]) * H + v,
            sizeof(float));
      }
    }
    if (tid < rc) {
      const int j = pe[s0 + tid];
      __pipeline_memcpy_async(sq_s + (c & 1) * CHUNK + tid, sq + eb + j,
                              sizeof(float));
      if (EXTRACT && directed)  // d2 >= 0 never passes a source's -1
        tj_s[(c & 1) * CHUNK + tid] = -1.f;
      else if (EXTRACT)
        __pipeline_memcpy_async(tj_s + (c & 1) * CHUNK + tid, t_in + eb + j,
                                sizeof(float));
      id_s[(c & 1) * CHUNK + tid] = j;
    }
    __pipeline_commit();
  };

  // d2 of query row q (compact position p0 + q) against source s
  auto put = [&](int q, float dot, float sqi, float ti, unsigned char* relq,
                 int s, float sqj, float tj, int j) {
    const float d2 =
        fmaxf(__fsub_rn(__fadd_rn(sqi, sqj), __fmul_rn(2.f, dot)), 0.f);
    const bool other = s != p0 + q;
    if (EXTRACT) {
      const bool u = other && (d2 <= ti || d2 <= tj);
      if (u && relq) relq[j] = 1;
      rows[q * N + s] = u ? d2 : CUDART_INF_F;
    } else {
      rows[q * N + s] = other ? d2 : CUDART_INF_F;
    }
  };

  const int nch = (n + CHUNK - 1) / CHUNK;
  stage(0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(c + 1);              // its buffer was freed by the last barrier
      __pipeline_wait_prior(1);  // chunk c has landed (this thread's part)
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();             // ... and every thread's part
    const int s = c * CHUNK + sl;
    if (la && s < n) {
      const int o = (c & 1) * CHUNK + sl;
      const float4* x =
          reinterpret_cast<const float4*>(src_s + (c & 1) * CHUNK * hs
                                          + sl * hs);
      const float4* ua = reinterpret_cast<const float4*>(q_s + qa * hs);
      const float4* ub = reinterpret_cast<const float4*>(q_s + qb * hs);
      float da = 0.f, db = 0.f;
#pragma unroll 4
      for (int v = 0; v < hp / 4; ++v) {
        const float4 xv = x[v], a = ua[v], bq = ub[v];
        da = __fadd_rn(da, __fmul_rn(a.x, xv.x));
        db = __fadd_rn(db, __fmul_rn(bq.x, xv.x));
        da = __fadd_rn(da, __fmul_rn(a.y, xv.y));
        db = __fadd_rn(db, __fmul_rn(bq.y, xv.y));
        da = __fadd_rn(da, __fmul_rn(a.z, xv.z));
        db = __fadd_rn(db, __fmul_rn(bq.z, xv.z));
        da = __fadd_rn(da, __fmul_rn(a.w, xv.w));
        db = __fadd_rn(db, __fmul_rn(bq.w, xv.w));
      }
      const float sqj = sq_s[o];
      const float tj = EXTRACT ? tj_s[o] : 0.f;
      const int j = id_s[o];
      put(qa, da, sqa, ta, rela, s, sqj, tj, j);
      if (lb) put(qb, db, sqb, tb, relb, s, sqj, tj, j);
    }
    __syncthreads();             // buffer c&1 is free for chunk c+2
  }

  // selection: warp w takes query row w; no block-wide barrier below
  const int p = p0 + warp;
  if (p >= N) return;
  if (warp >= nq) {
    pad_row(p);
    return;
  }
  float* row = rows + warp * N;
  const size_t i = eb + pe[p];
  if (!EXTRACT) {
    float last = CUDART_INF_F;
    const int got = select_smallest(row, n, lane, kc,
                                    [&](int, float m, int) { last = m; });
    if (lane == 0) t_out[i] = got == kc ? last : CUDART_INF_F;
    return;
  }

  int* io = idx_out + i * kc;
  float* dv = d2v_out + i * kc;
  // the row's members as (d2 bits, position) keys: d2 >= 0, so the keys
  // order as (d2, j) does, and positions are distinct
  unsigned long long* list = lists + warp * LIST;
  int m = 0;
  for (int base = 0; base < n; base += 32) {
    const int s = base + lane;
    const float v = s < n ? row[s] : CUDART_INF_F;
    const bool mem = v < CUDART_INF_F;
    const unsigned bal = __ballot_sync(FULL, mem);
    const int at = m + __popc(bal & ((1u << lane) - 1u));
    if (mem && at < LIST)
      list[at] = (static_cast<unsigned long long>(__float_as_uint(v)) << 32)
                 | static_cast<unsigned>(s);
    m += __popc(bal);
  }
  __syncwarp();
  int filled;
  if (m <= LIST) {  // each member's rank among the members is its slot
    for (int e = lane; e < m; e += 32) {
      const unsigned long long key = list[e];
      int r = 0;
      for (int f = 0; f < m; ++f) r += list[f] < key;
      if (r < kc) {
        io[r] = pe[static_cast<int>(key & 0xffffffffu)];
        dv[r] = __uint_as_float(static_cast<unsigned>(key >> 32));
      }
    }
    filled = min(m, kc);
  } else {  // a hub: cap rounds over the whole row
    filled = select_smallest(row, n, lane, kc, [&](int c, float v, int s) {
      if (lane == 0) {
        io[c] = pe[s];
        dv[c] = v;
      }
    });
  }
  for (int c = filled + lane; c < kc; c += 32) {
    io[c] = 0;
    dv[c] = CUDART_INF_F;
  }
}

template <bool EXTRACT>
cudaError_t launch(const float* h, const float* sq, const float* t_in,
                   const int* perm, const int* cnt, float* t_out, int* idx,
                   float* d2v, unsigned char* rel, int B, int N, int H,
                   int kc, cudaStream_t stream) {
  const int R = rows_per_block(N);
  const size_t smem = layout(EXTRACT, R, N, H).total;
  const dim3 grid((N + R - 1) / R, B);
  const cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<EXTRACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  knn_kernel<EXTRACT><<<grid, R * 32, smem, stream>>>(
      h, sq, t_in, perm, cnt, t_out, idx, d2v, rel, N, H, kc);
  return cudaGetLastError();
}

cudaError_t compact(const unsigned char* mask, int* perm, int* cnt, int B,
                    int N, cudaStream_t stream) {
  knn_compact_kernel<<<B, COMPACT_THREADS, 0, stream>>>(mask, perm, cnt, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// t [B,N] and the squared norms sq [B,N] from h [B,N,H] and mask [B,N];
// perm [B,N] and cnt [B] are scratch (the compaction).
int knn_kth(const float* h, const unsigned char* mask, float* sq, float* t,
            int* perm, int* cnt, int B, int N, int H, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * N;
  knn_sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(h, sq, rows, H);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = compact(mask, perm, cnt, B, N, st);
  if (err == cudaSuccess)
    err = launch<false>(h, sq, nullptr, perm, cnt, t, nullptr, nullptr,
                        nullptr, B, N, H, k, st);
  return static_cast<int>(err);
}

// idx, d2v [B,N,cap] and (when rel is not null) rel [B,N,N] from h, mask,
// the thresholds t and the squared norms sq, both from knn_kth; perm and
// cnt are scratch as for knn_kth.  directed != 0: the relation d2 <= t_i
// alone.  The flag travels to the kernel as the sign of its cap argument,
// so the kernels' names and parameter lists stay as they were.
int knn_extract(const float* h, const unsigned char* mask, const float* t,
                const float* sq, int* idx, float* d2v, unsigned char* rel,
                int* perm, int* cnt, int B, int N, int H, int cap,
                int directed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = compact(mask, perm, cnt, B, N, st);
  if (err == cudaSuccess)
    err = launch<true>(h, sq, t, perm, cnt, nullptr, idx, d2v, rel, B, N, H,
                       directed ? -cap : cap, st);
  return static_cast<int>(err);
}

}  // extern "C"
