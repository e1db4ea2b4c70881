// K5: whole-shard fused ADC scan with in-kernel k-selection (codes).
//
// Replaces the TPU kernel fusedadc_kernel (+ _select_and_carry), launched
// by fusedadc_pallas (src/repro/kernels/fusedscan/kernel.py). Computes
// kernels/fusedscan/ref.py fused_adc_topk_ref: for every lookup row the k
// smallest d2 = sum_j lut[q, j, codes[p, j]] over the live (id >= 0) rows
// of its leaf in the whole leaf-sorted shard, ascending by (distance, shard
// row), ids mapped through point_ids, inf / -1 where fewer than k match.
//
// Bound on the H100: ADC is gathers and adds, so the bound is bytes: each
// lookup row's 8 KiB LUT read once where its leaf holds a row (at most the
// 256 MiB LUT of the main path), the codes, leaves and ids of the rows of
// the leaves the lookup holds, and the (Q, k) output (32 MiB at k = 128):
// about 0.14 ms at the main path's call.
//
// Design: K2 gives a block a tile of 64 lookup rows and scans the hull of
// their leaf runs through shared memory. A lookup row's LUT here is 8 KiB,
// so a tile's LUTs (512 KiB) cannot sit in shared memory; instead one warp
// owns one lookup row, binary-searches its leaf's run [lo, hi) in the
// sorted point leaves (common.cuh, as K2 does), stages its LUT in shared
// memory only when the run is not empty, and scans exactly that run: the
// tile hull shrinks to the row's own run. Distance and sorted (distance,
// row) insertion are the device functions K4 uses, so the fused and the
// wave-sweep codes paths agree bit for bit. Tombstoned rows (id < 0) keep
// their leaf, which keeps the leaves sorted, and are skipped here; the TPU
// path masked their leaves instead, which breaks that order.
#include "common.cuh"

using namespace rt;

__global__ void __launch_bounds__(THREADS)
fusedadc_kernel(const uint8_t* __restrict__ codes,
                const int* __restrict__ pleaves,
                const int* __restrict__ pids,
                const float* __restrict__ lut,
                const int* __restrict__ qleaves, float* out_d, int* out_i,
                int P, int Q, int m, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lut_n = m * C;
  float *wl, *rd;
  int* ri;
  adc_warp_smem(smem_raw, lut_n, k, &wl, &rd, &ri);
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform; the kernel has no block barrier
  adc_reset_list(rd, ri, k);
  const int ql = qleaves[q];
  const long long lo = lower_bound_i32(pleaves, P, ql);
  const long long hi = upper_bound_i32(pleaves, P, ql);
  if (lo < hi) {
    adc_stage_lut(wl, lut + (size_t)q * lut_n, lut_n);
    adc_scan_rows(rd, ri, k, wl, codes, m, C, lo, hi,
                  [&](long long p) { return pids[p] >= 0; });
  }
  adc_emit(rd, ri, k, out_d + (size_t)q * k, out_i + (size_t)q * k,
           [&](int r) { return pids[r]; });
}

extern "C" int fusedadc_launch(const void* codes, const void* pleaves,
                               const void* pids, const void* lut,
                               const void* qleaves, void* out_d, void* out_i,
                               int P, int Q, int m, int C, int k,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int wpb = adc_warps_per_block(m * C, k);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = wpb * adc_warp_smem_bytes(m * C, k);
  cudaFuncSetAttribute(fusedadc_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fusedadc_kernel<<<(Q + wpb - 1) / wpb, wpb * 32, smem, st>>>(
      (const uint8_t*)codes, (const int*)pleaves, (const int*)pids,
      (const float*)lut, (const int*)qleaves, (float*)out_d, (int*)out_i, P, Q,
      m, C, k);
  return (int)cudaGetLastError();
}
