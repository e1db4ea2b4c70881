// K2: whole-shard fused scan with in-kernel k-selection (dense).
//
// Replaces the TPU kernel fusedscan_kernel (+ _select_and_carry), launched
// by fusedscan_pallas (src/repro/kernels/fusedscan/kernel.py). Computes
// kernels/fusedscan/ref.py: for every lookup row the k smallest
// ||p||^2 - 2 p.q over same-leaf points of the whole leaf-sorted shard,
// ascending by (distance, shard row), ids mapped through point_ids, with
// inf / -1 where fewer than k match or the row is tombstoned (id < 0).
//
// Bound on the H100: only same-leaf pairs carry work. With both sides
// leaf-sorted, a query tile meets a short run of point rows, so the useful
// fp32 operations (pairs x 2d) are small next to the bytes of the shard's
// rows that those runs cover; the roofline bound is reading the inputs.
// Measured with chip_smoke.py on an H100 80GB HBM3 (700 W limit), on the
// main path's call (2^25 index rows, 2^15 lookup rows): 25.4 ms against a
// 1.93 ms bound (the bytes of the 12.4 M rows whose leaves the lookup
// holds). Most likely the few query tiles whose leaf runs are long set
// the time, each scanned by one block (not yet traced per block);
// splitting a tile's run across blocks, as K1 splits points, is the first
// lever.
//
// Design: the TPU kernel walks every (query tile, point tile) cell in
// order and skips disjoint ones under pl.when. Here one block takes a tile
// of 64 lookup rows; each of its rows binary-searches its leaf's run in the
// sorted point leaves, and the block scans only the hull of those runs,
// point tile by point tile through shared memory, skipping tiles whose
// leaf range misses the query tile. Distance and insertion are the device
// functions K1 uses, so the fused and the wave-sweep paths agree bit for
// bit. The point leaves must be sorted ascending, as a DistributedIndex's
// are by construction (index_from_numpy checks arrays from outside).
#include "common.cuh"

using namespace rt;

__global__ void __launch_bounds__(THREADS)
fusedscan_kernel(const float* __restrict__ points,
                 const int* __restrict__ pleaves,
                 const int* __restrict__ pids,
                 const float* __restrict__ queries,
                 const int* __restrict__ qleaves, float* out_d, int* out_i,
                 int P, int Q, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long hull_lo, hull_hi;
  ScanSmem s = scan_smem(smem_raw, d, k);
  const long long q0 = (long long)blockIdx.x * TQ;
  const int nq = min(TQ, Q - (int)q0);
  if (threadIdx.x == 0) {
    hull_lo = (unsigned long long)P;
    hull_hi = 0ull;
  }
  scan_begin(s, queries, qleaves, q0, nq, d, k);  // ends in a barrier
  if (threadIdx.x < nq) {
    int lf = qleaves[q0 + threadIdx.x];
    long long lo = lower_bound_i32(pleaves, P, lf);
    long long hi = upper_bound_i32(pleaves, P, lf);
    if (lo < hi) {
      atomicMin(&hull_lo, (unsigned long long)lo);
      atomicMax(&hull_hi, (unsigned long long)hi);
    }
  }
  __syncthreads();
  scan_points(s, points, pleaves, (long long)hull_lo, (long long)hull_hi, nq,
              d, k);
  __syncthreads();
  for (int t = threadIdx.x; t < nq * k; t += THREADS) {
    int q = t / k;
    float dv = s.rd[t];
    int id = dv < CUDART_INF_F ? pids[s.ri[t]] : -1;
    size_t o = (size_t)(q0 + q) * k + (t - q * k);
    out_d[o] = id >= 0 ? dv : CUDART_INF_F;
    out_i[o] = id >= 0 ? id : -1;
  }
}

extern "C" int fusedscan_launch(const void* points, const void* pleaves,
                                const void* pids, const void* queries,
                                const void* qleaves, void* out_d, void* out_i,
                                int P, int Q, int d, int k, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  size_t smem = scan_smem_bytes(d, k);
  cudaFuncSetAttribute(fusedscan_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fusedscan_kernel<<<(Q + TQ - 1) / TQ, THREADS, smem, st>>>(
      (const float*)points, (const int*)pleaves, (const int*)pids,
      (const float*)queries, (const int*)qleaves, (float*)out_d, (int*)out_i,
      P, Q, d, k);
  return (int)cudaGetLastError();
}
