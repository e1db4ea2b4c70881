// K1: same-leaf partial L2 + per-query top-k over one wave tile.
//
// Replaces the TPU kernel l2topk_kernel, launched by l2topk_pallas
// (src/repro/kernels/l2topk/kernel.py). Computes kernels/l2topk/ref.py:
// for every query the k smallest ||p||^2 - 2 p.q over points of the same
// leaf, ascending by (distance, row); inf / -1 where fewer than k match.
//
// Bound on the H100: at the main path's wave (P = 4096 points, Q = 1024
// queries, d = 128) a dense scan would be 1.07 GFLOP of fp32 against 2.6 MB
// of inputs. Both sides are leaf-sorted in the engine, so only tiles whose
// leaf ranges overlap hold work: the kernel skips every point tile whose
// [min, max] leaf is disjoint from its query tile's (exact for any input
// order). What remains per wave is one query tile's worth of same-leaf
// pairs, so the roofline bound is the 2.6 MB read, 0.84 us. Measured with
// chip_smoke.py on an H100 80GB HBM3 (700 W limit): 0.178 ms per wave of
// real rows, launched back to back. Most likely the few blocks that hold
// work set it, running their point tiles one after another while the rest
// of the card idles (not yet traced per block); smaller splits are the
// first lever.
//
// Design: the TPU kernel walks point tiles in order on one core and keeps
// an unordered running table in VMEM. Here blocks run in parallel, so the
// grid is (query tiles of 64) x (point splits): each block stages its
// query tile in shared memory once, streams its split's point tiles
// through shared memory, forms a 64 x 64 distance tile with 4 x 4 register
// blocking in fp32 FMA (no TF32), and folds it into sorted per-query lists
// in shared memory. A second small kernel merges the splits' sorted lists.
// Both passes select through the same warp insertion as K2.
#include "common.cuh"

using namespace rt;

__global__ void __launch_bounds__(THREADS)
l2topk_partial_kernel(const float* __restrict__ points,
                      const int* __restrict__ pleaves,
                      const float* __restrict__ queries,
                      const int* __restrict__ qleaves, float* part_d,
                      int* part_i, int P, int Q, int d, int k,
                      int split_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem s = scan_smem(smem_raw, d, k);
  const long long q0 = (long long)blockIdx.x * TQ;
  const int nq = min(TQ, Q - (int)q0);
  const int split = blockIdx.y, n_splits = gridDim.y;
  const long long p_begin = (long long)split * split_rows;
  const long long p_end = min((long long)P, p_begin + split_rows);
  scan_begin(s, queries, qleaves, q0, nq, d, k);
  scan_points(s, points, pleaves, p_begin, p_end, nq, d, k);
  __syncthreads();
  for (int t = threadIdx.x; t < nq * k; t += THREADS) {
    int q = t / k, j = t - q * k;
    size_t o = ((size_t)(q0 + q) * n_splits + split) * k + j;
    part_d[o] = s.rd[q * k + j];
    part_i[o] = s.ri[q * k + j];
  }
}

// One warp per query: fold the n_splits sorted lists into one.
__global__ void __launch_bounds__(THREADS)
l2topk_merge_kernel(const float* __restrict__ part_d,
                    const int* __restrict__ part_i, float* out_d, int* out_i,
                    int Q, int k, int n_splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (THREADS / 32) + warp;
  if (q >= Q) return;  // warp-uniform; no block barrier below
  float* rd = reinterpret_cast<float*>(smem_raw) + warp * k;
  int* ri = reinterpret_cast<int*>(smem_raw + sizeof(float) * (THREADS / 32) * k) + warp * k;
  for (int j = lane; j < k; j += 32) {
    rd[j] = CUDART_INF_F;
    ri[j] = -1;
  }
  __syncwarp();
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t base = ((size_t)q * n_splits + sp) * k;
    for (int j0 = 0; j0 < k; j0 += 32) {
      int j = j0 + lane;
      float dv = j < k ? part_d[base + j] : CUDART_INF_F;
      int r = j < k ? part_i[base + j] : -1;
      warp_offer<DENSE_KCAP>(rd, ri, k, dv, r, dv < CUDART_INF_F);
    }
  }
  for (int j = lane; j < k; j += 32) {
    float dv = rd[j];
    out_d[(size_t)q * k + j] = dv;
    out_i[(size_t)q * k + j] = dv < CUDART_INF_F ? ri[j] : -1;
  }
}

extern "C" int l2topk_launch(const void* points, const void* pleaves,
                             const void* queries, const void* qleaves,
                             void* part_d, void* part_i, void* out_d,
                             void* out_i, int P, int Q, int d, int k,
                             int n_splits, int split_rows, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  size_t smem = scan_smem_bytes(d, k);
  cudaFuncSetAttribute(l2topk_partial_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((Q + TQ - 1) / TQ, n_splits);
  l2topk_partial_kernel<<<grid, THREADS, smem, st>>>(
      (const float*)points, (const int*)pleaves, (const float*)queries,
      (const int*)qleaves, (float*)part_d, (int*)part_i, P, Q, d, k,
      split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int wpb = THREADS / 32;
  size_t msmem = (sizeof(float) + sizeof(int)) * wpb * k;
  l2topk_merge_kernel<<<(Q + wpb - 1) / wpb, THREADS, msmem, st>>>(
      (const float*)part_d, (const int*)part_i, (float*)out_d, (int*)out_i, Q,
      k, n_splits);
  return (int)cudaGetLastError();
}
