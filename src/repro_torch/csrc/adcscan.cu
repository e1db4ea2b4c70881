// K4: same-leaf ADC distance + per-query top-k over one wave tile of codes.
//
// Replaces the TPU kernel adcscan_kernel, launched by adcscan_pallas
// (src/repro/kernels/adcscan/kernel.py). Computes kernels/adcscan/ref.py:
// for every query the k smallest d2 = sum_j lut[q, j, codes[p, j]] over
// code rows of the same leaf, ascending by (distance, row); inf / -1 where
// fewer than k match. k is the rerank depth (<= 128).
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
// by table slot. Neither is copied. Here one warp owns one query row: the
// block first reduces the tile's [min, max] point leaf, and a warp whose
// query leaf falls outside it writes an empty list without reading its
// LUT. Otherwise the warp stages its query's m * C LUT (8 KiB) in shared
// memory, walks the tile's rows 32 at a time, and for each row of its leaf
// gathers m LUT entries by the row's uint8 codes, adds them in order
// j = 0..m-1, and offers the sum to a sorted (distance, row) list in shared
// memory through common.cuh's warp insertion (the same as K5, so the wave
// sweep and the fused codes scan agree bit for bit). The codes are read as
// uint8, never widened. Each warp scans every row of the tile, so the
// result does not depend on the order of the rows.
#include "common.cuh"

using namespace rt;

__global__ void __launch_bounds__(THREADS)
adcscan_kernel(const uint8_t* __restrict__ codes,
               const int* __restrict__ pleaves,
               const float* __restrict__ lut,
               const int* __restrict__ qleaves,
               const long long* __restrict__ q_start, float* out_d,
               int* out_i, int P, int Q, int n_lut, int m, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int prange[2];
  const int lut_n = m * C;
  float *wl, *rd;
  int* ri;
  adc_warp_smem(smem_raw, lut_n, k, &wl, &rd, &ri);
  if (threadIdx.x == 0) {
    prange[0] = INT32_MAX;
    prange[1] = INT32_MIN;
  }
  __syncthreads();
  int lo = INT32_MAX, hi = INT32_MIN;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int lf = pleaves[p];
    lo = min(lo, lf);
    hi = max(hi, lf);
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&prange[0], lo);
    atomicMax(&prange[1], hi);
  }
  __syncthreads();
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform; no block barrier below
  adc_reset_list(rd, ri, k);
  const long long qg = (q_start ? *q_start : 0) + q;  // row of the LUT table
  if (qg < n_lut) {
    const int ql = qleaves[qg];
    if (ql >= prange[0] && ql <= prange[1]) {
      adc_stage_lut(wl, lut + (size_t)qg * lut_n, lut_n);
      adc_scan_rows(rd, ri, k, wl, codes, m, C, 0, P,
                    [&](long long p) { return pleaves[p] == ql; });
    }
  }
  adc_emit(rd, ri, k, out_d + (size_t)q * k, out_i + (size_t)q * k,
           [](int r) { return r; });
}

extern "C" int adcscan_launch(const void* codes, const void* pleaves,
                              const void* lut, const void* qleaves,
                              const void* q_start, void* out_d, void* out_i,
                              int P, int Q, int n_lut, int m, int C, int k,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int wpb = adc_warps_per_block(m * C, k);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = wpb * adc_warp_smem_bytes(m * C, k);
  cudaFuncSetAttribute(adcscan_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  adcscan_kernel<<<(Q + wpb - 1) / wpb, wpb * 32, smem, st>>>(
      (const uint8_t*)codes, (const int*)pleaves, (const float*)lut,
      (const int*)qleaves, (const long long*)q_start, (float*)out_d,
      (int*)out_i, P, Q, n_lut, m, C, k);
  return (int)cudaGetLastError();
}
