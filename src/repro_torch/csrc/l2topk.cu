// K1: same-leaf partial L2 + per-query top-k over one wave tile.
//
// Replaces the TPU kernel l2topk_kernel, launched by l2topk_pallas
// (src/repro/kernels/l2topk/kernel.py). Computes kernels/l2topk/ref.py:
// for every query the k smallest ||p||^2 - 2 p.q over points of the same
// leaf, ascending by (distance, row); inf / -1 where fewer than k match.
// The point leaves must be ascending, as every wave of a leaf-sorted
// DistributedIndex is (sentinel rows sort last); query leaves may come in
// any order.
//
// Bound on the H100: only same-leaf pairs carry work, and a pair needs its
// point row, its query row and the leaf arrays. At the main path's wave
// (P = 4096 points, Q = 1024 lookup rows, d = 128, k = 20) a handful of
// lookup rows share a leaf with the wave, so the roofline bound counts the
// points of the leaves some lookup row holds, those lookup rows, both leaf
// arrays and the (Q, k) output: bytes, under a microsecond. Measured with
// scripts/dense_kernels_ab.py on an H100 80GB HBM3 (700 W limit): 0.0208
// ms a real mid-shard wave (the earlier tile kernel: 0.182), 0.0272 ms on the
// wave with the most pairs (17 lookup rows x one 4,096-row run). A real
// wave's time is its busiest lookup row's chain, and one SM streams point
// rows through shared memory too slowly for a long run (with one block a
// row, the wave with the most pairs took 0.0786 ms), so a run is split
// across the SMs of a cluster.
//
// Design: the TPU kernel walks point tiles in order on one core and keeps
// an unordered running table in VMEM. Here a lookup row is the unit of
// work, as in K4 (adcscan.cu): its leaf's run [lo, hi) in the sorted point
// leaves is all it can match. The grid is one block an SM, in clusters of
// 4, as many clusters as the card holds at once (k1_clusters); cluster c
// takes the lookup rows c, c + n, c + 2 n, ... (n clusters), so the rows
// of one leaf (adjacent in a leaf-sorted slab) land on different
// clusters. A cluster reads its rows' leaves at once: a row whose leaf
// lies outside [leaves[0], leaves[P - 1]] gets its empty list straight
// away (every padded lookup row, PAD_QUERY_LEAF, and every row of
// a wave of LEAF_SENTINEL padding). For each other row every block finds
// the run with a whole warp (lower and upper bound interleaved: 3 rounds of
// loads at P = 4096) while the query row loads, and the cluster's 32 warps
// split exactly the run, 32 point rows a step each. A warp streams its rows
// through two shared-memory chunks of 32 rows x 64 columns (cp.async,
// 16-byte copies, one chunk in flight), with a row pitch of 68 floats, so
// that lane i reading row i as float4 is free of bank conflicts; lane i
// then carries its row's ||p||^2 and q.p fmaf chains in order c = 0..d-1
// across the chunks, one pair of chains a row, as K2 (fusedscan.cu) and
// the wide kernel (widetopk.cu) do (bit for bit the same distances). Chunk
// memory does not grow with d, so d up to 256 needs no other layout. Each
// warp merges a step's 32 candidates into its sorted (distance, row) list
// at once (warp_merge_offer); a block's 8 lists merge in a tree, and block 0 of
// the cluster folds the other 3 blocks' lists through distributed shared
// memory. Keys are unique, so the result is the plain version's whatever
// the split. One launch a wave; no merge kernel, no scratch. k <= 64 (the
// lists' register capacity); kernels/l2topk/ops.py sends a larger k to the
// wide kernel.
//
// Query tiles (the query-routed executor): p_start, when not null, is a
// one-element int64 on the device; the kernel then scans the P rows from
// that row on (a tile's point slab, whose start stays on the device) and
// reports rows relative to it, as if it were given the slab's copy.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace rt;
namespace cg = cooperative_groups;

namespace {

constexpr int K1_WARPS = THREADS / 32;
constexpr int K1_CLUSTER = 4;            // blocks (SMs) splitting one run
constexpr int K1_CK = 64;                // columns of a staged chunk
constexpr int K1_PITCH = K1_CK + 4;      // = 4 (mod 32): conflict-free rows
constexpr int K1_NBUF = 2;               // chunk ring of each warp
constexpr int K1_CHUNK = 32 * K1_PITCH;  // floats of one chunk

__host__ __device__ inline int k1_dpad(int d) {
  return (d + K1_CK - 1) / K1_CK * K1_CK;
}

inline size_t k1_smem_bytes(int d, int k) {
  return sizeof(float) * ((size_t)K1_WARPS * K1_NBUF * K1_CHUNK + k1_dpad(d)) +
         (sizeof(float) + sizeof(int)) * (size_t)K1_WARPS * k +
         sizeof(int) * (2 * THREADS + K1_WARPS);
}

// One warp's scan of its share of the run [lo, hi) into its list rd/ri:
// the row groups of 32 starting at lo + gw * 32, every stride rows (gw is
// the warp's index in its cluster). Chunk c is row group c / nslice,
// columns (c % nslice) * K1_CK ...
template <bool VEC>
__device__ inline void k1_scan_run(float* ring, const float* qs,
                                   const float* __restrict__ points,
                                   long long lo, long long hi, int gw,
                                   int stride, int d, int k, float* rd,
                                   int* ri) {
  const int lane = threadIdx.x & 31;
  const int nslice = k1_dpad(d) / K1_CK;
  const long long first = lo + gw * 32;
  const int groups = first < hi ? (int)((hi - first + stride - 1) / stride) : 0;
  const int n_chunks = groups * nslice;
  auto load = [&](int c) {
    const long long row0 = first + (long long)(c / nslice) * stride;
    const int col0 = (c % nslice) * K1_CK;
    load_chunk<VEC, K1_CK, K1_PITCH>(ring + (c % K1_NBUF) * K1_CHUNK, points,
                                     row0, hi, col0, d);
  };
#pragma unroll
  for (int c = 0; c < K1_NBUF - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }
  float pn = 0.f, dot = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + K1_NBUF - 1 < n_chunks) load(c + K1_NBUF - 1);
    cp_async_commit();  // possibly empty: one group a step
    cp_async_wait<K1_NBUF - 1>();
    __syncwarp();  // every lane's copies of chunk c have landed
    const int slice = c % nslice;
    if (slice == 0) pn = dot = 0.f;
    const float* row = ring + (c % K1_NBUF) * K1_CHUNK + lane * K1_PITCH;
    const float* qv = qs + slice * K1_CK;
#pragma unroll
    for (int c4 = 0; c4 < K1_CK; c4 += 4) {
      const float4 p = *reinterpret_cast<const float4*>(row + c4);
      const float4 q = *reinterpret_cast<const float4*>(qv + c4);
      pn = fmaf(p.x, p.x, pn);
      dot = fmaf(q.x, p.x, dot);
      pn = fmaf(p.y, p.y, pn);
      dot = fmaf(q.y, p.y, dot);
      pn = fmaf(p.z, p.z, pn);
      dot = fmaf(q.z, p.z, dot);
      pn = fmaf(p.w, p.w, pn);
      dot = fmaf(q.w, p.w, dot);
    }
    __syncwarp();  // every lane has read chunk c before its buffer refills
    if (slice == nslice - 1) {
      const long long p = first + (long long)(c / nslice) * stride + lane;
      warp_merge_offer<DENSE_KCAP>(rd, ri, k, __fsub_rn(pn, 2.0f * dot),
                                   (int)p, p < hi);
    }
  }
  cp_async_wait<0>();
}

__device__ inline void k1_write_empty(float* od, int* oi, int k, int t,
                                      int stride) {
  for (int j = t; j < k; j += stride) {
    od[j] = CUDART_INF_F;
    oi[j] = -1;
  }
}

template <bool VEC>
__global__ void __cluster_dims__(K1_CLUSTER, 1, 1) __launch_bounds__(THREADS)
l2topk_kernel(const float* __restrict__ points,
              const int* __restrict__ pleaves,
              const float* __restrict__ queries,
              const int* __restrict__ qleaves,
              const long long* __restrict__ p_start, float* out_d, int* out_i,
              int P, int Q, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (p_start) {  // a slab of the shard: rows are reported relative to it
    const long long s = *p_start;
    points += s * d;
    pleaves += s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dpad = k1_dpad(d);
  float* ring = reinterpret_cast<float*>(smem_raw);  // [warps][NBUF][chunk]
  float* qs = ring + K1_WARPS * K1_NBUF * K1_CHUNK;  // [dpad]
  float* lists_d = qs + dpad;                          // [warps][k]
  int* lists_i = reinterpret_cast<int*>(lists_d + K1_WARPS * k);
  int* match_q = lists_i + K1_WARPS * k;  // [THREADS] rows to scan, in order
  int* match_l = match_q + THREADS;       // [THREADS] their leaves
  int* warp_n = match_l + THREADS;        // [warps] matches of each warp
  float* rd = lists_d + warp * k;
  int* ri = lists_i + warp * k;
  const int leaf_min = pleaves[0], leaf_max = pleaves[P - 1];
  // this cluster's lookup rows: cl + j * n_cl for j < mine; every block of
  // the cluster takes the same rows and a quarter of each row's run
  const int n_cl = (int)gridDim.x / K1_CLUSTER, cl = (int)blockIdx.x / K1_CLUSTER;
  const int mine = (Q - cl + n_cl - 1) / n_cl;
  for (int j0 = 0; j0 < mine; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    const int q = cl + j * n_cl;
    int ql = 0;
    bool in = false;
    if (j < mine) {
      ql = qleaves[q];
      in = ql >= leaf_min && ql <= leaf_max;
      if (!in && rank == 0)
        k1_write_empty(out_d + (size_t)q * k, out_i + (size_t)q * k, k, 0, 1);
    }
    // compact the rows to scan in row order, the same in every block
    const unsigned vote = __ballot_sync(FULL, in);
    if (lane == 0) warp_n[warp] = __popc(vote);
    __syncthreads();
    int nm = 0, slot = 0;
    for (int w = 0; w < K1_WARPS; ++w) {
      slot += w < warp ? warp_n[w] : 0;
      nm += warp_n[w];
    }
    if (in) {
      slot += __popc(vote & ((1u << lane) - 1));
      match_q[slot] = q;
      match_l[slot] = ql;
    }
    __syncthreads();
    for (int m = 0; m < nm; ++m) {
      const int mq = match_q[m];
      float* od = out_d + (size_t)mq * k;
      int* oi = out_i + (size_t)mq * k;
      // the query row's load overlaps the run's search
      const float qv = threadIdx.x < d ? queries[(size_t)mq * d + threadIdx.x] : 0.f;
      long long lo, hi;  // every warp of the cluster finds the same run
      warp_run_i32(pleaves, P, match_l[m], &lo, &hi);
      if (lo >= hi) {  // cluster-uniform: no point of the wave shares the leaf
        if (rank == 0) k1_write_empty(od, oi, k, threadIdx.x, THREADS);
        continue;
      }
      if (threadIdx.x < dpad) qs[threadIdx.x] = qv;
      adc_reset_list(rd, ri, k);
      __syncthreads();  // the query row is staged
      k1_scan_run<VEC>(ring + warp * K1_NBUF * K1_CHUNK, qs, points, lo, hi,
                       rank * K1_WARPS + warp, K1_CLUSTER * K1_WARPS * 32, d, k,
                       rd, ri);
      for (int s = 1; s < K1_WARPS; s <<= 1) {
        __syncthreads();  // warp + s finished its list
        if ((warp & (2 * s - 1)) == 0 && warp + s < K1_WARPS)
          warp_merge_list<DENSE_KCAP>(rd, ri, lists_d + (warp + s) * k,
                                      lists_i + (warp + s) * k, k);
      }
      cluster.sync();  // every block's list (its warp 0's) is final
      if (rank == 0 && warp == 0) {
        for (int r = 1; r < K1_CLUSTER; ++r)
          warp_merge_list<DENSE_KCAP>(rd, ri, cluster.map_shared_rank(lists_d, r),
                                      cluster.map_shared_rank(lists_i, r), k);
        adc_emit(rd, ri, k, od, oi, [](int r) { return r; });
      }
      cluster.sync();  // rank 0 has read every list; lists and query free
    }
  }
}

// The clusters the card holds at once, one block an SM: read once per
// instantiation with cudaOccupancyMaxActiveClusters at the largest shared
// memory size (every size leaves room for one block an SM only). A cluster
// lies inside one GPC, so this can be fewer than SMs / 4 (30, not 33, on
// an H100 80GB HBM3); a grid larger than it would run its last clusters
// as a second wave.
template <bool VEC>
int k1_clusters(int* out) {
  static int clusters = 0;
  if (!clusters) {
    const int smem = (int)k1_smem_bytes(MAX_D, DENSE_KCAP);
    cudaError_t e = cudaFuncSetAttribute(
        l2topk_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((sms > K1_CLUSTER ? sms / K1_CLUSTER : 1) * K1_CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    int n = 0;  // the cluster shape comes from __cluster_dims__
    e = cudaOccupancyMaxActiveClusters(&n, l2topk_kernel<VEC>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    clusters = n;
  }
  *out = clusters;
  return 0;
}

template <bool VEC>
int k1_launch(const float* points, const int* pleaves, const float* queries,
              const int* qleaves, const long long* p_start, float* out_d,
              int* out_i, int P, int Q, int d, int k, cudaStream_t st) {
  int clusters = 0;
  const int e = k1_clusters<VEC>(&clusters);
  if (e) return e;
  if (Q < clusters) clusters = Q;
  l2topk_kernel<VEC><<<clusters * K1_CLUSTER, THREADS, k1_smem_bytes(d, k), st>>>(
      points, pleaves, queries, qleaves, p_start, out_d, out_i, P, Q, d, k);
  return (int)cudaGetLastError();
}

}  // namespace

// p_start may be null (rows from 0) or a device int64: the first of the P
// rows to scan, which stay inside the points the caller holds.
extern "C" int l2topk_launch(const void* points, const void* pleaves,
                             const void* queries, const void* qleaves,
                             const void* p_start, void* out_d, void* out_i,
                             int P, int Q, int d, int k, void* stream) {
  if (P < 1 || Q < 1 || d < 1 || d > MAX_D || k < 1 || k > DENSE_KCAP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte copies need 16-byte aligned rows
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  const long long* ps = (const long long*)p_start;
  return vec ? k1_launch<true>((const float*)points, (const int*)pleaves,
                               (const float*)queries, (const int*)qleaves, ps,
                               (float*)out_d, (int*)out_i, P, Q, d, k, st)
             : k1_launch<false>((const float*)points, (const int*)pleaves,
                                (const float*)queries, (const int*)qleaves, ps,
                                (float*)out_d, (int*)out_i, P, Q, d, k, st);
}

// The clusters of 4 blocks that K1's grid holds (see k1_clusters).
extern "C" int l2topk_clusters(void* out) {
  return k1_clusters<true>(static_cast<int*>(out));
}
