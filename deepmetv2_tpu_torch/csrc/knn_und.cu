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
//  - A block owns a tile of Q = 64 consecutive entries of perm (query
//    rows), 256 threads, three blocks an SM.  A block past the event's
//    count writes the padded-row outputs and exits; so do the padded rows
//    of the event's last tile.
//  - The block streams the event's real sources in chunks of S = 64 rows,
//    and the features of both the query tile and the chunk in slices of
//    KS = 16, gathered through perm by cp.async into a ring of NSTAGE = 3
//    stages (two slices in flight while one is computed); each chunk's
//    node ids are copied two chunks ahead, so a slice's gather reads them
//    from shared memory.  Each source slice is read from L2 once per 64
//    query rows.  Each thread accumulates a 4 x 4 register tile of dot
//    products (4 query rows against 4 sources) by float4 shared loads:
//    eight loads per 64 products.  Staged rows have a stride of an odd
//    count of 16-byte words, so a quarter-warp's loads of eight source rows
//    are free of bank conflicts; the query loads are broadcasts.  Shared
//    memory depends on neither N nor H: a wider h is more slices.
//  - Selection streams.  Each query row belongs to one half-warp (16
//    threads, the 64 sources of each chunk), which keeps in shared memory
//    the row's list of the kc (k or cap) smallest keys (d2 bits, position)
//    seen so far, ascending, and a queue of 16 to 32 keys (as many as the
//    list).  d2 >= 0, so keys order as (d2, j) does, and positions are
//    distinct, so the k-th key's d2 is the k-th smallest d2 counted with
//    multiplicity, and the first cap keys among the members are the first
//    cap members.  After a chunk's last slice each pair is tested once
//    against the row's largest kept d2 (after the member test, in the
//    extraction); the few that pass are tested exactly (a real source, not
//    the row, a key below the list's largest) and appended to the queue by
//    ballots, and the queue is merged into the list (ranks, in place) when
//    the next append could overflow it and once at the end.  Any member
//    count streams: a hub needs no fallback.  The relation rows are zeroed
//    by 16-byte stores and each member's byte is set where its pair is
//    tested.  Every output has one writer; no float atomics.
//
// What bounds it on the card: the distance products the data needs, one
// per pair of real nodes of an event, each pair once (d2 is symmetric):
// H*n*(n-1) FP32 operations per event of n real nodes, against the bytes of
// h and the outputs, with the extraction's B*N*N relation bytes (when asked
// for) the largest; chip_smoke.py computes both from its data.  The kernels
// compute each unordered pair twice (once per row) and spend a separate
// multiply and add on each product (no FMA: the contract), so they can
// reach at best a quarter of that bound, at the FP32 issue rate of the
// products.  What holds them under it: the selection (the member test and
// the filter for every pair, the queues and merges for the few that pass,
// more of them in knn_kth), then the barrier and the wait of each slice.
// Times, and their split by probes/knn_breakdown.py, in PERF.md.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef unsigned long long u64;

constexpr int TR = 4;                      // query rows of a thread's tile
constexpr int TC = 4;                      // sources of a thread's tile
constexpr int GX = 16;                     // threads that share a query row
constexpr int S = GX * TC;                 // real sources staged per chunk
constexpr int Q = 64;                      // query rows per block
constexpr int THREADS = Q / TR * GX;
constexpr int KS = 16;                     // features per slice
constexpr int KST = KS + 4;                // staged row stride: 5 float4s
constexpr int NSTAGE = 3;                  // slices in the ring
constexpr int QCAP = 32;                   // the most queued keys per row
constexpr int NIDS = 8;                    // chunks' node ids kept (ring)
constexpr int MAX_KC = 128;                // the largest k or cap
constexpr int COMPACT_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
// the key of no source: above every (d2 bits, position) key; a list starts
// as SENTINEL | slot, so that its keys are distinct
constexpr u64 SENTINEL = 0xffffffff00000000ull;
constexpr unsigned INF_BITS = 0x7f800000u;

static_assert(GX == 16, "a query row's threads are one half-warp");
static_assert(THREADS >= S, "the chunk's metadata is one copy a thread");
static_assert(QCAP >= GX && QCAP % GX == 0, "a ballot's keys fit the queue");

// Features rounded up to whole float4s (the pad columns hold zeros, which
// add +0 to a dot product and so leave d2 bit for bit as it was).
__host__ __device__ int padded_h(int H) { return (H + 3) & ~3; }

struct Layout {  // byte offsets into dynamic shared memory
  size_t list, queue, stage, meta, ids, qmeta, total;
};

// lists [Q][kc] and queues [Q][QCAP] of keys, the ring [NSTAGE][Q + S][KST]
// (query slice, then source slice), per stage the chunk's sq and t
// [NSTAGE][2][S], the chunks' node ids [NIDS][S], then the query rows' sq,
// t and ids [3][Q].
__host__ __device__ Layout layout(int kc) {
  Layout l;
  l.list = 0;
  l.queue = l.list + sizeof(u64) * Q * kc;
  l.stage = l.queue + sizeof(u64) * Q * QCAP;
  l.meta = l.stage + sizeof(float) * NSTAGE * (Q + S) * KST;
  l.ids = l.meta + sizeof(float) * NSTAGE * 2 * S;
  l.qmeta = l.ids + sizeof(int) * NIDS * S;
  l.total = l.qmeta + sizeof(float) * 3 * Q;
  return l;
}

// the d2 of a key, +inf for the sentinels
__device__ __forceinline__ float key_d2(u64 key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  return hi < INF_BITS ? __uint_as_float(hi) : CUDART_INF_F;
}

__device__ __forceinline__ u64 make_key(float d2, int s) {
  return (static_cast<u64>(__float_as_uint(d2)) << 32)
         | static_cast<unsigned>(s);
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

// Adds four features (float4 column v of the staged slice) to the thread's
// TR x TC tile of dot products, each product and sum rounded on its own.
__device__ __forceinline__ void dot_quad(float (&acc)[TR][TC],
                                         const float* qrow, const float* srow,
                                         int v) {
  float4 b[TC];
#pragma unroll
  for (int cc = 0; cc < TC; ++cc)
    b[cc] = *reinterpret_cast<const float4*>(srow + cc * GX * KST + 4 * v);
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(qrow + r * KST + 4 * v);
#pragma unroll
    for (int cc = 0; cc < TC; ++cc) {
      float d = acc[r][cc];
      d = __fadd_rn(d, __fmul_rn(a.x, b[cc].x));
      d = __fadd_rn(d, __fmul_rn(a.y, b[cc].y));
      d = __fadd_rn(d, __fmul_rn(a.z, b[cc].z));
      d = __fadd_rn(d, __fmul_rn(a.w, b[cc].w));
      acc[r][cc] = d;
    }
  }
}

// Merges a row's queue (qn keys) into its list (kc keys, ascending), keeping
// the kc smallest, and returns the list's largest key.  Every lane of the
// warp calls it, each half-warp (lane hl of 16) for its own row.  Keys are
// distinct, so each key's slot is its rank: a queued key's is the count of
// list and queued keys below it; a listed key moves up by the count of
// queued keys below it, in passes from the top down, so that no pass
// overwrites a key a lower pass has yet to read.
__device__ __noinline__ u64 merge(u64* list, const u64* queue, int kc, int qn,
                                  int hl) {
  __syncwarp();  // every queued key is written
  u64 qk[QCAP / GX];
  int qp[QCAP / GX];
#pragma unroll
  for (int a = 0; a < QCAP / GX; ++a) {
    const int e = hl + GX * a;
    qk[a] = 0;
    qp[a] = kc;
    if (e < qn) {
      const u64 key = queue[e];
      int lo = 0, hi = kc;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (list[mid] < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      for (int j = 0; j < qn; ++j) lo += queue[j] < key;
      qk[a] = key;
      qp[a] = lo;
    }
  }
  for (int base = (kc - 1) & ~(GX - 1); base >= 0; base -= GX) {
    const int e = base + hl;
    u64 key = 0;
    int pos = kc;
    if (e < kc) {
      key = list[e];
      pos = e;
      for (int j = 0; j < qn; ++j) pos += queue[j] < key;
    }
    __syncwarp();  // this pass's keys are read
    if (pos < kc) list[pos] = key;
  }
  __syncwarp();    // every listed key has moved
#pragma unroll
  for (int a = 0; a < QCAP / GX; ++a)
    if (qp[a] < kc) list[qp[a]] = qk[a];
  __syncwarp();
  return list[kc - 1];
}

template <bool EXTRACT>
__global__ void __launch_bounds__(THREADS, 3)
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
  const Layout L = layout(kc);

  const int tid = threadIdx.x, lane = tid & 31;
  const int hl = tid % GX, qy = tid / GX;  // source group, query group
  const size_t eb = static_cast<size_t>(blockIdx.y) * N;
  const int* pe = perm + eb;
  const float* hb = h + eb * H;
  const int n = cnt[blockIdx.y];
  const int p0 = blockIdx.x * Q;

  // the defined outputs of the padded query row at position p, by the
  // threads l of nl
  auto pad_row = [&](int p, int l, int nl) {
    const size_t i = eb + pe[p];
    if (!EXTRACT) {
      if (l == 0) t_out[i] = CUDART_INF_F;
      return;
    }
    for (int c = l; c < kc; c += nl) {
      idx_out[i * kc + c] = 0;
      d2v_out[i * kc + c] = CUDART_INF_F;
    }
  };

  if (EXTRACT && rel_out) {  // every relation row of the block starts at 0
    if (N % 16 == 0) {
      const int w16 = N / 16;
      for (int e = tid; e < Q * w16; e += THREADS) {
        const int r = e / w16;
        if (p0 + r < N)
          reinterpret_cast<uint4*>(rel_out + (eb + pe[p0 + r]) * N)
              [e - r * w16] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < Q * N; e += THREADS) {
        const int r = e / N;
        if (p0 + r < N) rel_out[(eb + pe[p0 + r]) * N + (e - r * N)] = 0;
      }
    }
  }
  if (p0 >= n) {  // padded query rows only: no distances
    for (int r = qy; r < Q; r += THREADS / GX)
      if (p0 + r < N) pad_row(p0 + r, hl, GX);
    return;
  }
  const int nq = min(Q, n - p0);  // real query rows of this block
  u64* lists = reinterpret_cast<u64*>(smem + L.list);
  u64* queues = reinterpret_cast<u64*>(smem + L.queue);
  float* ring = reinterpret_cast<float*>(smem + L.stage);
  float* meta = reinterpret_cast<float*>(smem + L.meta);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* qsq_s = reinterpret_cast<float*>(smem + L.qmeta);
  float* qt_s = qsq_s + Q;
  int* qid_s = reinterpret_cast<int*>(qt_s + Q);

  for (int e = tid; e < Q * kc; e += THREADS)
    lists[e] = SENTINEL | static_cast<unsigned>(e % kc);
  for (int r = tid; r < Q; r += THREADS) {  // rows past nq repeat the last
    const int j = pe[p0 + min(r, nq - 1)];
    qid_s[r] = j;
    qsq_s[r] = sq[eb + j];
    qt_s[r] = EXTRACT ? t_in[eb + j] : 0.f;
  }
  for (int e = tid; e < 2 * S && e < n; e += THREADS) ids[e] = pe[e];
  __syncthreads();  // the first two chunks' ids and qid_s feed the staging

  const int hp = padded_h(H);
  const int nks = (hp + KS - 1) / KS;  // slices per chunk
  const int steps = (n + S - 1) / S * nks;
  const bool vec = (H & 3) == 0;

  // Step st (chunk c = st / nks, slice ks) into stage st % NSTAGE; with a
  // chunk's first slice its sq and t into meta (c % NSTAGE) and the ids of
  // chunk c + 2 into the ids ring.  Each chunk's ids land two chunks ahead
  // of their use, so the staging of a slice reads them from shared memory;
  // NIDS chunks of ids outlast every reader (the selection two chunks on).
  int c_in = 0, ks_in = 0;  // the next step to stage
  auto stage = [&](int st) {
    if (st < steps) {
      const int c = c_in, ks = ks_in;
      const int s0 = c * S, rs = min(S, n - s0);
      const int k0 = ks * KS, nv = min(KS, hp - k0) / 4;
      const int* cid = ids + (c % NIDS) * S;
      float* buf = ring + (st % NSTAGE) * (Q + S) * KST;
#pragma unroll
      for (int e = tid; e < (Q + S) * (KS / 4); e += THREADS) {
        const int r = e / (KS / 4), v = e % (KS / 4);
        if (v >= nv || r >= Q + rs) continue;  // past h, or past the event
        const int j = r < Q ? qid_s[r] : cid[r - Q];
        const float* src = hb + static_cast<size_t>(j) * H + k0 + 4 * v;
        float* dst = buf + r * KST + 4 * v;
        if (vec) {
          __pipeline_memcpy_async(dst, src, 16);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (k0 + 4 * v + x < H)
              __pipeline_memcpy_async(dst + x, src + x, sizeof(float));
            else
              dst[x] = 0.f;
          }
        }
      }
      if (ks == 0 && tid < S) {
        if (tid < rs) {
          float* m = meta + (c % NSTAGE) * 2 * S;
          const int j = cid[tid];
          __pipeline_memcpy_async(m + tid, sq + eb + j, sizeof(float));
          if (EXTRACT && directed)  // no d2 passes a source's -inf
            m[S + tid] = -CUDART_INF_F;
          else if (EXTRACT)
            __pipeline_memcpy_async(m + S + tid, t_in + eb + j,
                                    sizeof(float));
        }
        const int s2 = s0 + 2 * S + tid;
        if (s2 < n)
          __pipeline_memcpy_async(ids + ((c + 2) % NIDS) * S + tid, pe + s2,
                                  sizeof(int));
      }
      if (++ks_in == nks) {
        ks_in = 0;
        ++c_in;
      }
    }
    __pipeline_commit();
  };

  float thr[TR];  // each row's largest kept d2, a filter that no key of
                  // its list fails (+inf until the list is full)
  int qn[TR];     // each row's queued keys
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    thr[r] = CUDART_INF_F;
    qn[r] = 0;
  }
  // a queue as long as the list, 16 to 32 keys: a merge costs O(kc + qcap)
  // per key, and a longer queue lowers the filter later
  const int qcap = min(max(kc, GX), QCAP);
  const unsigned mine = lane < GX ? 0x0000ffffu : 0xffff0000u;  // half-warp
  const unsigned below = mine & ((1u << lane) - 1u);
  float acc[TR][TC];

  for (int st = 0; st < NSTAGE - 1; ++st) stage(st);
  int c = 0, ks = 0;  // the step computed
  for (int st = 0; st < steps; ++st) {
    __pipeline_wait_prior(NSTAGE - 2);  // step st has landed (this thread's)
    __syncthreads();                    // ... everyone's; stage st-1 is free
    stage(st + NSTAGE - 1);
    const float* buf = ring + (st % NSTAGE) * (Q + S) * KST;
    const float* qrow = buf + qy * TR * KST;  // this thread's rows qy*TR + r
    const float* srow = buf + (Q + hl) * KST;  // and sources hl + GX*cc
    if (ks == 0) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] = 0.f;
    }
    const int nv = min(KS, hp - ks * KS) / 4;
    if (nv == KS / 4) {
#pragma unroll
      for (int v = 0; v < KS / 4; ++v) dot_quad(acc, qrow, srow, v);
    } else {
      for (int v = 0; v < nv; ++v) dot_quad(acc, qrow, srow, v);
    }
    const int cs = c;  // the chunk of this step
    if (++ks < nks) continue;
    ks = 0;
    ++c;

    // The chunk is complete.  Each pair's x = (sq_i + sq_j) - 2 dot (its d2
    // is max(x, 0), so x <= t iff d2 <= t for every t >= 0) is filtered
    // against its row's largest kept d2, after the member test in the
    // extraction (a directed source's threshold is -inf).
    const float* m = meta + (cs % NSTAGE) * 2 * S;
    const int* cid = ids + (cs % NIDS) * S;
    float sqj[TC], tj[TC];
    int sp[TC];  // the sources' positions in perm
#pragma unroll
    for (int cc = 0; cc < TC; ++cc) {
      const int o = hl + GX * cc;
      sqj[cc] = m[o];
      tj[cc] = EXTRACT ? m[S + o] : 0.f;
      sp[cc] = cs * S + o;
    }
    unsigned fb = 0;  // bit r*TC+cc: the pair passes the filter
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = qy * TR + r;
      const float sqi = qsq_s[row], ti = EXTRACT ? qt_s[row] : 0.f;
#pragma unroll
      for (int cc = 0; cc < TC; ++cc) {
        const float x =
            __fsub_rn(__fadd_rn(sqi, sqj[cc]), __fmul_rn(2.f, acc[r][cc]));
        acc[r][cc] = x;
        bool f = x <= thr[r];
        if (EXTRACT) f = f && (x <= ti || x <= tj[cc]);
        fb |= f ? 1u << (r * TC + cc) : 0u;
      }
    }
    if (EXTRACT && rel_out) {  // every member's byte (the dense path only)
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = qy * TR + r;
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) {
          const float d2 = fmaxf(acc[r][cc], 0.f);
          if (row < nq && sp[cc] < n && sp[cc] != p0 + row
              && (d2 <= qt_s[row] || d2 <= tj[cc]))
            rel_out[(eb + qid_s[row]) * N + cid[hl + GX * cc]] = 1;
        }
      }
    }
    const unsigned any = __reduce_or_sync(FULL, fb);
    if (any == 0) continue;

    // The pairs that passed, of real rows and sources other than the row,
    // whose key is below the row's largest kept key, into the row's queue
    // by ballots, one tile column at a time; where a queue could overflow,
    // it is merged into its list first.
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (!((any >> (r * TC)) & 0xfu)) continue;
      const int row = qy * TR + r;
      u64* lr = lists + row * kc;
      u64* qr = queues + row * QCAP;
      u64 top = lr[kc - 1];
#pragma unroll
      for (int cc = 0; cc < TC; ++cc) {
        const int bit = r * TC + cc;
        if (!((any >> bit) & 1u)) continue;
        const u64 key = make_key(fmaxf(acc[r][cc], 0.f), sp[cc]);
        bool f = ((fb >> bit) & 1u) && row < nq && sp[cc] < n
                 && sp[cc] != p0 + row && key < top;
        unsigned bal = __ballot_sync(FULL, f);
        if (__any_sync(FULL, qn[r] + __popc(bal & mine) > qcap)) {
          top = merge(lr, qr, kc, qn[r], hl);
          thr[r] = key_d2(top);
          qn[r] = 0;
          f = f && key < top;
          bal = __ballot_sync(FULL, f);
        }
        if (f) qr[qn[r] + __popc(bal & below)] = key;
        qn[r] += __popc(bal & mine);
      }
    }
  }

  // the queues' last keys, then each row's outputs from its list
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    if (__any_sync(FULL, qn[r] > 0))
      merge(lists + (qy * TR + r) * kc, queues + (qy * TR + r) * QCAP, kc,
            qn[r], hl);
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = qy * TR + r;
    if (p0 + row >= N) continue;
    if (row >= nq) {
      pad_row(p0 + row, hl, GX);
      continue;
    }
    const size_t i = eb + qid_s[row];
    const u64* lr = lists + row * kc;
    if (!EXTRACT) {  // the k-th key's d2; +inf if the row ran dry
      if (hl == 0) t_out[i] = key_d2(lr[kc - 1]);
      continue;
    }
    for (int e = hl; e < kc; e += GX) {
      const u64 key = lr[e];
      const bool fin = static_cast<unsigned>(key >> 32) < INF_BITS;
      idx_out[i * kc + e] = fin ? pe[static_cast<unsigned>(key)] : 0;
      d2v_out[i * kc + e] = fin ? key_d2(key) : CUDART_INF_F;
    }
  }
}

template <bool EXTRACT>
cudaError_t launch(const float* h, const float* sq, const float* t_in,
                   const int* perm, const int* cnt, float* t_out, int* idx,
                   float* d2v, unsigned char* rel, int B, int N, int H,
                   int kc, cudaStream_t stream) {
  const int kabs = kc < 0 ? -kc : kc;
  if (kabs < 1 || kabs > MAX_KC) return cudaErrorInvalidValue;
  const size_t smem = layout(kabs).total;
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<EXTRACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(knn_kernel<EXTRACT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Q - 1) / Q, B);
  knn_kernel<EXTRACT><<<grid, THREADS, smem, stream>>>(
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
// perm [B,N] and cnt [B] are scratch (the compaction).  1 <= k <= 128.
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
// 1 <= cap <= 128.
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
