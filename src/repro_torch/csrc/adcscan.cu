// K4: same-leaf ADC distance + per-query top-k over one wave tile of codes.
//
// Replaces the TPU kernel adcscan_kernel, launched by adcscan_pallas
// (src/repro/kernels/adcscan/kernel.py). Computes kernels/adcscan/ref.py:
// for every query the k smallest d2 = sum_j lut[q, j, codes[p, j]] over
// the live (id >= 0) code rows of the same leaf, ascending by (distance,
// row); inf / -1 where fewer than k match. k is the rerank depth (<= 128).
// The point leaves must be ascending, as a wave of the leaf-sorted shard
// is.
//
// Bound on the H100: ADC is m gathers and m adds a pair, so the roofline
// bound is bytes. At the main path's wave (P = 4096 rows of m = 8 uint8
// codes, Q = 1024 lookup rows of 8 KiB LUT each, k = 128) a query's LUT is
// needed only when some row of the tile shares its leaf: the bound counts
// the codes, both leaf arrays, those queries' LUTs and the (Q, k) output
// (1 MiB), about 0.3-0.5 us; the whole 8 MiB LUT slab would be 2.5 us.
//
// In the wave sweep the kernel gets the whole LUT table and the slab's start
// as a device pointer (no host sync, no per-wave copy of the 8 MiB slab):
// output row q is lookup row *q_start + q.
//
// Design: the TPU kernel expresses the gather as m one-hot GEMMs on the MXU
// and keeps an unordered replace-the-current-max table, which orders ties
// by table slot. Neither is copied. Here a block owns one lookup row and,
// as K5 does over the whole shard, finds its leaf's run in the wave's
// sorted point leaves: a row whose leaf lies outside [leaves[0],
// leaves[P - 1]] writes an empty list at once (two reads); any other
// searches its run [lo, hi) with a whole warp (common.cuh, 3 rounds of
// loads at P = 4096), stages its m * C LUT (8 KiB) in shared memory only
// when the run is not empty, and scans exactly that run, skipping
// tombstones (id < 0), which keep their leaf so that the order holds. For
// each row it gathers m LUT entries by the row's uint8 codes and adds them
// in order j = 0..m-1.
//
// A wave holds about 16 leaves, and few of a slab's lookup rows share one,
// so the kernel's time is the chain of its busiest lookup row: a leaf's run
// is about 256 rows and can fill the wave. The block's warps therefore
// split the run, 32 rows a step each, into their own sorted (distance,
// row) lists in shared memory, and merge the lists in a tree (warp w takes
// w + s for s = 1, 2, 4). Every list update is common.cuh's batch merge
// (warp_merge_offer): a step's candidates that beat the k-th entry are
// sorted across the warp and merged at once, not inserted one at a time.
// Keys (distance, row) are unique, so the result is the k smallest of the
// run in that order whatever the split: bit for bit the plain version's
// and K5's (whose insertion, warp_offer, builds the same lists). The codes
// are read as uint8, never widened.
#include "common.cuh"

using namespace rt;

__global__ void __launch_bounds__(THREADS)
adcscan_kernel(const uint8_t* __restrict__ codes,
               const int* __restrict__ pleaves, const int* __restrict__ pids,
               const float* __restrict__ lut,
               const int* __restrict__ qleaves,
               const long long* __restrict__ q_start, float* out_d,
               int* out_i, int P, int n_lut, int m, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lut_n = m * C, nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wl = reinterpret_cast<float*>(smem_raw);    // [lut_n]
  float* lists_d = wl + lut_n;                         // [nw][k]
  int* lists_i = reinterpret_cast<int*>(lists_d + nw * k);  // [nw][k]
  const int q = blockIdx.x;
  float* od = out_d + (size_t)q * k;
  int* oi = out_i + (size_t)q * k;
  const long long qg = (q_start ? *q_start : 0) + q;  // row of the LUT table
  long long lo = 0, hi = 0;  // every warp finds the same run
  if (qg < n_lut) {
    const int ql = qleaves[qg];
    if (ql >= pleaves[0] && ql <= pleaves[P - 1])
      warp_run_i32(pleaves, P, ql, &lo, &hi);
  }
  if (lo >= hi) {  // block-uniform: no row of the wave shares the leaf
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      od[j] = CUDART_INF_F;
      oi[j] = -1;
    }
    return;
  }
  float* rd = lists_d + warp * k;
  int* ri = lists_i + warp * k;
  adc_reset_list(rd, ri, k);
  const float* src = lut + (size_t)qg * lut_n;
  for (int j = threadIdx.x; j < lut_n; j += blockDim.x) wl[j] = src[j];
  __syncthreads();
  for (long long base = lo + warp * 32; base < hi; base += nw * 32) {
    const long long p = base + lane;
    const bool in = p < hi && (!pids || pids[p] >= 0);
    const float dv = in ? adc_dist(wl, codes + p * m, m, C) : CUDART_INF_F;
    warp_merge_offer<ADC_KCAP>(rd, ri, k, dv, (int)p, in);
  }
  for (int s = 1; s < nw; s <<= 1) {
    __syncthreads();  // warp + s finished its list
    if ((warp & (2 * s - 1)) == 0 && warp + s < nw) {
      const float* sd = lists_d + (warp + s) * k;
      const int* si = lists_i + (warp + s) * k;
      for (int c = 0; c < k; c += 32) {
        const int j = c + lane;
        const float dv = j < k ? sd[j] : CUDART_INF_F;
        warp_merge_offer<ADC_KCAP>(rd, ri, k, dv, j < k ? si[j] : -1,
                                   dv < CUDART_INF_F);
      }
    }
  }
  if (warp == 0) adc_emit(rd, ri, k, od, oi, [](int r) { return r; });
}

// pids may be null: every row is live. One block of up to 8 warps per
// lookup row, as many as shared memory holds beside the LUT.
extern "C" int adcscan_launch(const void* codes, const void* pleaves,
                              const void* pids, const void* lut,
                              const void* qleaves, const void* q_start,
                              void* out_d, void* out_i, int P, int Q,
                              int n_lut, int m, int C, int k, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t lut_bytes = sizeof(float) * (size_t)m * C;
  const size_t list_bytes = (sizeof(float) + sizeof(int)) * (size_t)k;
  const size_t cap = 227 * 1024 - 64;  // H100 opt-in shared memory
  if (P < 1 || Q < 1 || k < 1 || k > ADC_KCAP || lut_bytes + list_bytes > cap)
    return (int)cudaErrorInvalidValue;
  const size_t fit = (cap - lut_bytes) / list_bytes;
  const int nw = fit < (size_t)(THREADS / 32) ? (int)fit : THREADS / 32;
  const size_t smem = lut_bytes + nw * list_bytes;
  cudaFuncSetAttribute(adcscan_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  adcscan_kernel<<<Q, nw * 32, smem, st>>>(
      (const uint8_t*)codes, (const int*)pleaves, (const int*)pids,
      (const float*)lut, (const int*)qleaves, (const long long*)q_start,
      (float*)out_d, (int*)out_i, P, n_lut, m, C, k);
  return (int)cudaGetLastError();
}
