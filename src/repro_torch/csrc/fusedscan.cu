// K2: whole-shard fused scan with in-kernel k-selection (dense).
//
// Replaces the TPU kernel fusedscan_kernel (+ _select_and_carry), launched
// by fusedscan_pallas (src/repro/kernels/fusedscan/kernel.py). Computes
// kernels/fusedscan/ref.py: for every lookup row the k smallest
// ||p||^2 - 2 p.q over same-leaf points of the whole leaf-sorted shard,
// ascending by (distance, shard row), ids mapped through point_ids, with
// inf / -1 where fewer than k match or the kept row is tombstoned (id < 0).
// The point leaves must ascend (a DistributedIndex's do); query leaves may
// come in any order. k <= 64 (the lists' register capacity, KCAP =
// DENSE_KCAP); the same kernels at KCAP = WIDE_KCAP serve 64 < k <= 256
// (below), and kernels/fusedscan/ops.py sends a larger k to the block
// list kernel (widetopk.cu).
//
// Bound on the H100: only same-leaf pairs carry work, and a pair needs its
// point row once. At the main path's call (2^25 index rows, 2^15 lookup
// rows, d = 128, k = 20) the rows of the leaves the lookup holds are about
// 12.4 M (6.4 GB, 1.93 ms at 3.35 TB/s), while the pairs' fp32 operations
// (about 69.5 M pairs x 2 x 128) take about 0.27 ms: bytes.
//
// Design. A leaf group is a maximal run of consecutive lookup rows with the
// same leaf (the lookup is leaf-sorted, so a leaf's rows are one group; an
// unsorted lookup stays correct with smaller groups). A group is cut into
// group tiles of at most F_G = 8 rows. A tile finds its leaf's run
// [lo, hi) in the point leaves once, with a whole warp (warp_run_i32: 5
// rounds of loads over 2^25 rows), and streams the run's rows through
// shared memory with cp.async: each warp takes 32 rows a step, in chunks
// of 32 rows x 32 columns (row pitch 36 floats, two chunks a warp, one in
// flight), and lane i carries row i's ||p||^2 fmaf chain and one q.p chain
// for every row of the tile (the tile's query rows staged in shared
// memory, read as broadcasts), in K1's order c = 0..d-1, so K1 and K2 stay
// bit-identical. Only same-leaf pairs are evaluated (a tile's rows and its
// run share the leaf), and each run row is read from device memory once
// per tile. A step's candidates for a query row that beat its list's k-th
// entry wait in the warp's buffer of 32 for that row (warp_buffered_offer),
// which merges into the list (warp_merge_offer) only when it would
// overflow: once a list holds k entries, few candidates a step qualify,
// and a merge a step would cost more than the step's fmaf chains. The
// warps' lists of a query row are then folded into warp 0's
// (warp_merge_list), one warp per query row. F_G = 8, not 16: the q.p
// chains of a lane are unrolled over F_G, and at 16 the unrolled chains
// and their guards (most tiles hold one or two rows) cost more on the card
// than the run re-reads that the smaller tiles add.
//
// Work distribution (the main path has about 15,500 groups, most of one
// or two rows, and runs from a row to about 30,000). Two kernels on one
// stream, no host sync and no pass over the shard:
//  * fusedscan_kernel: one block (4 warps, about 53 KiB of shared memory
//    at d = 128, k = 20, so four blocks an SM) per lookup row. A row whose
//    leaf lies outside [leaves[0], leaves[P - 1]] (padding) writes its
//    empty list; a row that is not its group's first returns at once; a
//    group's first row finds the group's end, then its run, and scans each
//    of the group's tiles with its 4 warps splitting the run when the run
//    is at most F_LONG = 4096 rows. So the tens of thousands of short
//    groups run as many blocks in flight, each as long as its own run.
//  * fusedscan_long_kernel: a run longer than F_LONG is split across the
//    4 blocks of a thread block cluster (16 warps), the blocks' lists
//    folded by block 0 through distributed shared memory, as K1 does. The
//    first kernel appends such tiles to a list in a scratch buffer (an
//    atomic counter); this kernel launches as many clusters as the card
//    holds at once (cudaOccupancyMaxActiveClusters), and cluster c takes
//    tiles c, c + n, ... Without the split, the largest leaf's tile alone
//    (about 15 MB through one SM) would take most of a millisecond.
// The tombstone rule stays: a kept row with id < 0 is emitted as -1 / inf.
//
// The wide range (64 < k <= 256, KCAP = WIDE_KCAP): the same tiles, runs,
// clusters, staging and buffered merges, with each warp's list of k for
// each tile row in shared memory (4 x 8 x k entries: 25.6 KB at k = 100,
// three blocks an SM); the merges shift KCAP / 32 = 8 registers a lane
// (4 for a list of k <= 128). A tile row's 4 lists (16 over a cluster)
// are folded by rank with the whole block
// (block_merge_pairs: 2 levels through the ring, which the scan no longer
// needs; the cluster's other blocks' lists copied in through distributed
// shared memory first), not 32 entries a merge on one warp, which would
// take ceil(k / 32) merges a list. Measured at k = 100 on the main path's
// call (scripts/wide_segsum_ab.py and chip_smoke.py's P7 phase, H100 80GB
// HBM3, 700.00 W): 5.07-5.19 ms (3.75-3.78 at k = 20; the block list
// kernel 10.92-10.97).
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; its resident cluster count is kept per device.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace rt;
namespace cg = cooperative_groups;

namespace {

constexpr int F_WARPS = 4;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_G = 8;                 // rows of a group tile
constexpr int F_CK = 32;               // columns of a staged chunk
constexpr int F_PITCH = F_CK + 4;      // = 4 (mod 32): conflict-free rows
constexpr int F_NBUF = 2;              // chunk ring of each warp
constexpr int F_CHUNK = 32 * F_PITCH;  // floats of one chunk
constexpr int F_CLUSTER = 4;           // blocks splitting a long run
constexpr int F_LONG = 4096;           // runs longer than this are split

__host__ __device__ inline int f_dpad(int d) {
  return (d + F_CK - 1) / F_CK * F_CK;
}

inline size_t f_smem_bytes(int d, int k) {
  return sizeof(float) *
             ((size_t)F_WARPS * F_NBUF * F_CHUNK + (size_t)F_G * f_dpad(d)) +
         (sizeof(float) + sizeof(int)) * (size_t)F_WARPS * F_G * (k + 32) +
         sizeof(int) * F_WARPS * F_G;
}

// A block's shared memory: each warp's chunk ring, the tile's query rows
// [F_G][dpad], each warp's lists [F_WARPS][F_G][k], and each warp's
// candidate buffers [F_WARPS][F_G][32] with their counts [F_WARPS][F_G].
struct FSmem {
  float* ring;
  float* qs;
  float* ld;
  int* li;
  float* bd;
  int* bi;
  int* nb;
};

__device__ inline FSmem f_smem(void* base, int d, int k) {
  FSmem s;
  s.ring = reinterpret_cast<float*>(base);
  s.qs = s.ring + F_WARPS * F_NBUF * F_CHUNK;
  s.ld = s.qs + F_G * f_dpad(d);
  s.li = reinterpret_cast<int*>(s.ld + F_WARPS * F_G * k);
  s.bd = reinterpret_cast<float*>(s.li + F_WARPS * F_G * k);
  s.bi = reinterpret_cast<int*>(s.bd + F_WARPS * F_G * 32);
  s.nb = s.bi + F_WARPS * F_G * 32;
  return s;
}

// One warp's scan of its share of the run [lo, hi) for the tile's nt query
// rows into its lists wld/wli ([F_G][k]), through its candidate buffers
// wbd/wbi ([F_G][32], counts wnb [F_G]): the row groups of 32 starting at
// lo + gw * 32, every stride rows (gw is the warp's index in its cluster).
// Chunk c is row group c / nslice, columns (c % nslice) * F_CK ...
template <bool VEC, int KCAP>
__device__ inline void f_scan(float* ring, const float* qs, int nt,
                              const float* __restrict__ points, long long lo,
                              long long hi, int gw, int stride, int d, int k,
                              float* wld, int* wli, float* wbd, int* wbi,
                              int* wnb) {
  const int lane = threadIdx.x & 31;
  const int dpad = f_dpad(d), nslice = dpad / F_CK;
  const long long first = lo + gw * 32;
  const int groups = first < hi ? (int)((hi - first + stride - 1) / stride) : 0;
  const int n_chunks = groups * nslice;
  auto load = [&](int c) {
    load_chunk<VEC, F_CK, F_PITCH>(ring + (c % F_NBUF) * F_CHUNK, points,
                                   first + (long long)(c / nslice) * stride, hi,
                                   (c % nslice) * F_CK, d);
  };
#pragma unroll
  for (int c = 0; c < F_NBUF - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }
  float pn = 0.f, dot[F_G];
  for (int c = 0; c < n_chunks; ++c) {
    if (c + F_NBUF - 1 < n_chunks) load(c + F_NBUF - 1);
    cp_async_commit();  // possibly empty: one group a step
    cp_async_wait<F_NBUF - 1>();
    __syncwarp();  // every lane's copies of chunk c have landed
    const int slice = c % nslice;
    if (slice == 0) {
      pn = 0.f;
#pragma unroll
      for (int j = 0; j < F_G; ++j) dot[j] = 0.f;
    }
    float* buf = ring + (c % F_NBUF) * F_CHUNK;
    const float* row = buf + lane * F_PITCH;
    const float* qv = qs + slice * F_CK;
#pragma unroll
    for (int c4 = 0; c4 < F_CK; c4 += 4) {
      const float4 p = *reinterpret_cast<const float4*>(row + c4);
      pn = fmaf(p.x, p.x, pn);
      pn = fmaf(p.y, p.y, pn);
      pn = fmaf(p.z, p.z, pn);
      pn = fmaf(p.w, p.w, pn);
#pragma unroll
      for (int j = 0; j < F_G; ++j) {
        if (j < nt) {
          const float4 q = *reinterpret_cast<const float4*>(qv + j * dpad + c4);
          dot[j] = fmaf(q.x, p.x, dot[j]);
          dot[j] = fmaf(q.y, p.y, dot[j]);
          dot[j] = fmaf(q.z, p.z, dot[j]);
          dot[j] = fmaf(q.w, p.w, dot[j]);
        }
      }
    }
    __syncwarp();  // every lane has read chunk c
    if (slice == nslice - 1) {
      // the row's nt distances go through the chunk's buffer (refilled only
      // at the next step), so that one merge serves every query row
#pragma unroll
      for (int j = 0; j < F_G; ++j)
        if (j < nt) buf[j * 32 + lane] = __fsub_rn(pn, 2.0f * dot[j]);
      __syncwarp();
      const long long p = first + (long long)(c / nslice) * stride + lane;
#pragma unroll 1
      for (int j = 0; j < nt; ++j)
        warp_buffered_offer<KCAP>(wld + j * k, wli + j * k, k, wbd + j * 32,
                                  wbi + j * 32, wnb + j, buf[j * 32 + lane],
                                  (int)p, p < hi);
      __syncwarp();  // every lane has read the distances
    }
  }
  cp_async_wait<0>();
#pragma unroll 1
  for (int j = 0; j < nt; ++j)
    warp_flush<KCAP>(wld + j * k, wli + j * k, k, wbd + j * 32, wbi + j * 32,
                     wnb + j);
}

// The wide range's fold of the tile's nt rows' F_WARPS lists each (row j's
// list of warp w at (w * F_G + j) * k) into row j's list of warp 0, by rank
// with the whole block, through the ring. The caller synchronises before.
__device__ inline void f_fold_rows(const FSmem& s, int nt, int k) {
  static_assert(F_WARPS == 4, "two levels of pairs");
  static_assert(F_G * F_WARPS <= FOLD_LISTS, "a tile's lists");
  __shared__ int n[2][F_G * F_WARPS];  // the lists' finite counts
  float* td = s.ring;  // [nt][2][k] distances, then rows
  int* ti = reinterpret_cast<int*>(s.ring + 2 * F_G * k);
  const auto by_row = [k](int l) { return ((l % F_WARPS) * F_G + l / F_WARPS) * k; };
  const auto flat = [k](int l) { return l * k; };
  block_count_lists(s.ld, s.li, by_row, nt * F_WARPS, k, n[0]);
  __syncthreads();
  block_merge_pairs(s.ld, s.li, by_row, n[0], td, ti, flat, n[1], nt * F_WARPS, k);
  __syncthreads();
  block_merge_pairs(td, ti, flat, n[1], s.ld, s.li, flat, n[0], nt * 2, k);
  __syncthreads();
}

// One group tile, lookup rows q0 .. q0 + nt - 1 of leaf run [lo, hi), by
// the CL blocks of a cluster (CL = 1: one block); rank is the block's.
template <bool VEC, int CL, int KCAP>
__device__ inline void f_tile(const FSmem& s, cg::cluster_group* cluster,
                              int rank, const float* __restrict__ points,
                              const int* __restrict__ pids,
                              const float* __restrict__ queries, float* out_d,
                              int* out_i, int q0, int nt, long long lo,
                              long long hi, int d, int k) {
  const int warp = threadIdx.x >> 5;
  const int dpad = f_dpad(d);
  for (int t = threadIdx.x; t < nt * dpad; t += F_THREADS) {
    const int j = t / dpad, c = t - j * dpad;
    s.qs[t] = c < d ? queries[(size_t)(q0 + j) * d + c] : 0.f;
  }
  for (int t = threadIdx.x; t < F_WARPS * nt * k; t += F_THREADS) {
    const int w = t / (nt * k), jt = t - w * nt * k;
    s.ld[w * F_G * k + jt] = CUDART_INF_F;
    s.li[w * F_G * k + jt] = -1;
  }
  if (threadIdx.x < F_WARPS * F_G) s.nb[threadIdx.x] = 0;
  __syncthreads();  // the query rows are staged, the lists and buffers reset
  f_scan<VEC, KCAP>(s.ring + warp * F_NBUF * F_CHUNK, s.qs, nt, points, lo, hi,
                    rank * F_WARPS + warp, CL * F_WARPS * 32, d, k,
                    s.ld + warp * F_G * k, s.li + warp * F_G * k,
                    s.bd + warp * F_G * 32, s.bi + warp * F_G * 32,
                    s.nb + warp * F_G);
  __syncthreads();
  if constexpr (KCAP == DENSE_KCAP) {
    if constexpr (CL > 1) cluster->sync();  // every block's lists are final
    if (rank == 0) {
      // query row j: warp j % F_WARPS folds every other list of row j (the
      // cluster's other blocks' through distributed shared memory) into
      // warp 0's
      for (int j = warp; j < nt; j += F_WARPS)
        for (int r = 0; r < CL; ++r)
          for (int w = r == 0 ? 1 : 0; w < F_WARPS; ++w) {
            const float* sd = s.ld + (w * F_G + j) * k;
            const int* si = s.li + (w * F_G + j) * k;
            if constexpr (CL > 1) {
              if (r > 0) {
                sd = cluster->map_shared_rank(sd, r);
                si = cluster->map_shared_rank(si, r);
              }
            }
            warp_merge_list<DENSE_KCAP>(s.ld + j * k, s.li + j * k, sd, si, k);
          }
    }
  } else {
    f_fold_rows(s, nt, k);  // each block's rows into its warp 0's lists
    if constexpr (CL > 1) {
      static_assert(CL == F_WARPS, "the blocks' lists take the warps' places");
      cluster->sync();  // every block's lists are final
      if (rank == 0) {
        // block r's list of row j into this block's list of warp r, row j
        for (int t = threadIdx.x; t < (CL - 1) * nt * k; t += F_THREADS) {
          const int r = 1 + t / (nt * k), jt = t % (nt * k);
          s.ld[r * F_G * k + jt] = cluster->map_shared_rank(s.ld, r)[jt];
          s.li[r * F_G * k + jt] = cluster->map_shared_rank(s.li, r)[jt];
        }
        __syncthreads();
        f_fold_rows(s, nt, k);
      }
    }
  }
  if (rank == 0) {
    __syncthreads();
    for (int t = threadIdx.x; t < nt * k; t += F_THREADS) {
      const float dv = s.ld[t];
      const int id = dv < CUDART_INF_F ? pids[s.li[t]] : -1;
      const size_t o = (size_t)q0 * k + t;  // row q0 + t / k, entry t % k
      out_d[o] = id >= 0 ? dv : CUDART_INF_F;
      out_i[o] = id >= 0 ? id : -1;
    }
  }
  if constexpr (CL > 1)
    cluster->sync();  // block 0 has read every list: lists and queries free
  else
    __syncthreads();
}

__device__ inline void f_write_empty(float* out_d, int* out_i, int q0,
                                     int rows, int k) {
  for (long long t = threadIdx.x; t < (long long)rows * k; t += F_THREADS) {
    out_d[(size_t)q0 * k + t] = CUDART_INF_F;
    out_i[(size_t)q0 * k + t] = -1;
  }
}

// One block per lookup row; the first row of each group does the group's
// work, or appends its tiles to long_tiles when its run is long.
template <bool VEC, int KCAP>
__global__ void __launch_bounds__(F_THREADS, KCAP == DENSE_KCAP ? 4 : 3)
fusedscan_kernel(const float* __restrict__ points,
                 const int* __restrict__ pleaves, const int* __restrict__ pids,
                 const float* __restrict__ queries,
                 const int* __restrict__ qleaves, float* out_d, int* out_i,
                 int4* long_tiles, int* n_long, int P, int Q, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x;
  const int ql = qleaves[q];
  if (ql < pleaves[0] || ql > pleaves[P - 1]) {  // no run: padding, say
    f_write_empty(out_d, out_i, q, 1, k);
    return;
  }
  if (q > 0 && qleaves[q - 1] == ql) return;  // not its group's first row
  int end = q + 1;  // the group's end, 32 rows a round (every warp alike)
  for (;;) {
    const int i = end + lane;
    const unsigned same = __ballot_sync(FULL, i < Q && qleaves[i] == ql);
    if (same != FULL) {
      end += __ffs(~same) - 1;
      break;
    }
    end += 32;
  }
  long long lo, hi;
  warp_run_i32(pleaves, P, ql, &lo, &hi);
  if (lo >= hi) {  // a leaf the shard does not hold
    f_write_empty(out_d, out_i, q, end - q, k);
    return;
  }
  if (hi - lo > F_LONG) {  // the cluster kernel splits it
    if (threadIdx.x == 0)
      for (int t0 = q; t0 < end; t0 += F_G)
        long_tiles[atomicAdd(n_long, 1)] =
            make_int4(t0, min(F_G, end - t0), (int)lo, (int)hi);
    return;
  }
  const FSmem s = f_smem(smem_raw, d, k);
  for (int t0 = q; t0 < end; t0 += F_G)
    f_tile<VEC, 1, KCAP>(s, nullptr, 0, points, pids, queries, out_d, out_i, t0,
                         min(F_G, end - t0), lo, hi, d, k);
}

template <bool VEC, int KCAP>
__global__ void __cluster_dims__(F_CLUSTER, 1, 1)
__launch_bounds__(F_THREADS, KCAP == DENSE_KCAP ? 4 : 3)
fusedscan_long_kernel(const float* __restrict__ points,
                      const int* __restrict__ pids,
                      const float* __restrict__ queries, float* out_d,
                      int* out_i, const int4* __restrict__ long_tiles,
                      const int* __restrict__ n_long, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const FSmem s = f_smem(smem_raw, d, k);
  const int n_cl = (int)gridDim.x / F_CLUSTER, cl = (int)blockIdx.x / F_CLUSTER;
  const int n = *n_long;
  for (int t = cl; t < n; t += n_cl) {
    const int4 tile = long_tiles[t];
    f_tile<VEC, F_CLUSTER, KCAP>(s, &cluster, rank, points, pids, queries,
                                 out_d, out_i, tile.x, tile.y, tile.z, tile.w,
                                 d, k);
  }
}

// The clusters of 4 blocks the card holds at once at this shared memory
// size on the current device (cudaOccupancyMaxActiveClusters, read again
// only when it changes there).
template <bool VEC, int KCAP>
int f_clusters(int smem, int* out) {
  static int last_smem_of[MAX_DEVICES] = {}, clusters_of[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  int &last_smem = last_smem_of[dev], &clusters = clusters_of[dev];
  if (smem != last_smem) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((sms > F_CLUSTER ? sms / F_CLUSTER : 1) * F_CLUSTER);
    cfg.blockDim = dim3(F_THREADS);
    cfg.dynamicSmemBytes = smem;
    int n = 0;  // the cluster shape comes from __cluster_dims__
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, fusedscan_long_kernel<VEC, KCAP>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    clusters = n;
    last_smem = smem;
  }
  *out = clusters;
  return 0;
}

template <bool VEC, int KCAP>
int f_launch(const float* points, const int* pleaves, const int* pids,
             const float* queries, const int* qleaves, float* out_d,
             int* out_i, int* scratch, int P, int Q, int d, int k,
             cudaStream_t st) {
  const int smem = (int)f_smem_bytes(d, k);
  cudaError_t e = cudaFuncSetAttribute(
      fusedscan_kernel<VEC, KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fusedscan_long_kernel<VEC, KCAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  const int ce = f_clusters<VEC, KCAP>(smem, &clusters);
  if (ce) return ce;
  int* n_long = scratch;  // scratch: the counter, 3 ints of padding, tiles
  int4* long_tiles = reinterpret_cast<int4*>(scratch + 4);
  e = cudaMemsetAsync(n_long, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  fusedscan_kernel<VEC, KCAP><<<Q, F_THREADS, smem, st>>>(
      points, pleaves, pids, queries, qleaves, out_d, out_i, long_tiles,
      n_long, P, Q, d, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fusedscan_long_kernel<VEC, KCAP><<<clusters * F_CLUSTER, F_THREADS, smem, st>>>(
      points, pids, queries, out_d, out_i, long_tiles, n_long, d, k);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: 4 + 4 * Q int32, 16-byte aligned (the long tiles' list). k <= 64
// runs at KCAP 64, 64 < k <= 256 (the wide range) at KCAP 256.
extern "C" int fusedscan_launch(const void* points, const void* pleaves,
                                const void* pids, const void* queries,
                                const void* qleaves, void* out_d, void* out_i,
                                void* scratch, int P, int Q, int d, int k,
                                void* stream) {
  if (P < 1 || Q < 1 || d < 1 || d > MAX_D || k < 1 || k > WIDE_KCAP ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte copies need 16-byte aligned rows
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  auto launch = k <= DENSE_KCAP ? (vec ? f_launch<true, DENSE_KCAP>
                                       : f_launch<false, DENSE_KCAP>)
                                : (vec ? f_launch<true, WIDE_KCAP>
                                       : f_launch<false, WIDE_KCAP>);
  return launch((const float*)points, (const int*)pleaves, (const int*)pids,
                (const float*)queries, (const int*)qleaves, (float*)out_d,
                (int*)out_i, (int*)scratch, P, Q, d, k, st);
}
