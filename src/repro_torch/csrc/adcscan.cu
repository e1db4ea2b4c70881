// K4: same-leaf ADC distance + per-query top-k over one wave tile of codes.
//
// Replaces the TPU kernel adcscan_kernel, launched by adcscan_pallas
// (src/repro/kernels/adcscan/kernel.py). Computes kernels/adcscan/ref.py:
// for every query the k smallest d2 = sum_j lut[q, j, codes[p, j]] over
// the live (id >= 0) code rows of the same leaf, ascending by (distance,
// row); inf / -1 where fewer than k match. k is the rerank depth.
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
// by table slot. Neither is copied. Here a block owns one lookup row and
// finds its leaf's run in the sorted point leaves: a row whose leaf lies
// outside [leaves[0], leaves[P - 1]] writes an empty list at once (two
// reads); any other searches its run [lo, hi) with a whole warp
// (common.cuh, 3 rounds of loads at P = 4096, 5 over a 2^25-row shard),
// stages its m * C LUT (8 KiB) in shared memory only when the run is not
// empty, and scans exactly that run, skipping tombstones (id < 0), which
// keep their leaf so that the order holds. For each row it gathers m LUT
// entries by the row's uint8 codes and adds them in order j = 0..m-1.
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
// run in that order whatever the split: bit for bit the plain version's.
// The codes are read as uint8, never widened. k <= 128 (the lists'
// register capacity, KCAP = ADC_KCAP).
//
// The wide range, 128 < k <= 256, is K5's alone (KCAP = WIDE_KCAP): a PQ
// search's rerank depth of 256, say. Its one list shifts through KCAP / 32
// = 8 registers a lane, and it takes 8 rows a thread a step (twice the
// loads in flight during its longer merges). K4 sends a k past 128, and
// K5 a k past 256, to the block list kernel (widetopk.cu; routes in
// kernels/l2topk/ops.py). A K4 with lists of 256, its 8 lists folded by
// rank in the LUT's room, took 0.0322-0.0345 ms a wave at rerank 256
// against the block list kernel's 0.0324-0.0328 in the same calls: no
// resolved gain, so it went. Measured at rerank 256 (scripts/
// wide_segsum_ab.py and chip_smoke.py's P7 phase, NVIDIA H100 80GB HBM3,
// 700.00 W): K5 1.469-1.476 ms (1.00-1.01 at 128; 1.54-1.55 at 4 rows a
// step; a histogram gate that offered only the bins reaching k took 2.38:
// its pass of distances cost what the merges it saved did).
//
// K5 (fusedadc.cu) is this kernel over the whole shard: P its rows, no
// q_start, and FUSED set: rows leave through point_ids (-1 where the
// distance is inf), and a lookup row's run, 2,100 rows on average there
// against about 250 in a wave, is selected by one warp into one list
// through a candidate buffer (adc_block_select), not by 8 warps' lists:
// over the shard, filling and merging 8 lists of k = 128 cost far more
// than the distances.
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; it sets its shared-memory size on every launch.
#include "common.cuh"

using namespace rt;

constexpr int K5_WARPS = 1;  // a whole-shard call's block: one warp
constexpr int K5_ROWS = 4;   // rows a thread a step in a whole-shard call
// in the wide range: twice the rows a step, twice the loads in flight
// during the longer merges of lists of 256
constexpr int K5_WIDE_ROWS = 8;

// K5's selection (FUSED): one list for the block (warp 0's) in place of a
// list a warp. Each step the block's threads take K5_ROWS rows each (their
// codes and ids fetched a step ahead, 8 bytes a row when m = 8, so that
// the loads are in flight during the step's merges); the rows that beat
// the list's k-th entry are appended to a block buffer bd/bi, and warp 0
// merges the buffer 32 candidates at a time (warp_merge_offer) once it
// holds 32, keeping the rest for the next step, and all of it at the
// run's end. The list fills once (k candidates), not once a warp, and a
// merge takes 32 candidates, not the few of one step: over the whole shard
// (about 2,100 rows a lookup row, k = 128) that is about 15 merges a
// lookup row in place of about 94. Rows leave through pids.
template <int KCAP>
__device__ inline void adc_block_select(
    const uint8_t* __restrict__ codes, const int* __restrict__ pids,
    const float* wl, float* rd, int* ri, float* bd, int* bi, int* n_buf,
    long long lo, long long hi, int m, int C, int k, float* od, int* oi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ROWS = KCAP > ADC_KCAP ? K5_WIDE_ROWS : K5_ROWS;
  const int step = ROWS * blockDim.x;
  // m = 8 (the PQ default): a row's codes are one 8-byte load
  const bool w8 = m == 8 && reinterpret_cast<uintptr_t>(codes) % 8 == 0;
  uint2 cw[ROWS];  // the step's codes (w8) and ids, fetched a step ahead
  int id[ROWS];
  auto fetch = [&](long long b) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long p = b + i * blockDim.x + threadIdx.x;
      id[i] = p < hi ? pids[p] : -1;
      cw[i] = p < hi && w8 ? reinterpret_cast<const uint2*>(codes)[p]
                           : make_uint2(0, 0);
    }
  };
  // row p's distance from its codes c (w8) and id (inf: a tombstone)
  auto dist = [&](uint2 c, int rid, long long p) {
    float acc = CUDART_INF_F;
    if (rid >= 0 && w8) {
      acc = 0.f;  // adc_dist's order: j = 0..7 from 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned w = j < 4 ? c.x : c.y;
        acc = __fadd_rn(acc, wl[j * C + ((w >> (8 * (j & 3))) & 0xff)]);
      }
    } else if (rid >= 0) {
      acc = adc_dist(wl, codes + p * m, m, C);
    }
    return acc;
  };
  fetch(lo);
  for (long long base = lo; base < hi; base += step) {  // block-uniform
    float dv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      dv[i] = dist(cw[i], id[i], base + i * blockDim.x + threadIdx.x);
    if (base + step < hi) fetch(base + step);  // in flight during the merges
    const float kd = rd[k - 1];
    const int kr = ri[k - 1];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int p = (int)(base + i * blockDim.x + threadIdx.x);
      const bool ok = dv[i] < CUDART_INF_F && lex_less(dv[i], p, kd, kr);
      const unsigned mk = __ballot_sync(FULL, ok);
      int at = 0;
      if (lane == 0 && mk) at = atomicAdd(n_buf, __popc(mk));
      at = __shfl_sync(FULL, at, 0) + __popc(mk & ((1u << lane) - 1));
      if (ok) {
        bd[at] = dv[i];
        bi[at] = p;
      }
    }
    __syncthreads();  // the step's candidates are in the buffer
    if (warp == 0) {
      const bool last = base + step >= hi;
      const int n = *n_buf;
      int done = 0;
      for (; n - done >= 32 || (last && done < n); done += 32) {
        const int j = done + lane;
        warp_merge_offer<KCAP>(rd, ri, k, j < n ? bd[j] : CUDART_INF_F,
                               j < n ? bi[j] : -1, j < n);
      }
      const int rest = done < n ? n - done : 0;  // < 32: to the front
      if (done > 0 && rest > 0) {
        const float v = lane < rest ? bd[done + lane] : 0.f;
        const int r = lane < rest ? bi[done + lane] : 0;
        __syncwarp();
        if (lane < rest) {
          bd[lane] = v;
          bi[lane] = r;
        }
      }
      if (lane == 0) *n_buf = rest;
    }
    __syncthreads();  // the list and the buffer are settled
  }
  if (warp == 0) adc_emit(rd, ri, k, od, oi, [=](int r) { return pids[r]; });
}

template <bool FUSED, int KCAP>
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
  if (!FUSED || warp == 0) adc_reset_list(rd, ri, k);
  const float* src = lut + (size_t)qg * lut_n;
  for (int j = threadIdx.x; j < lut_n; j += blockDim.x) wl[j] = src[j];
  if constexpr (FUSED) {
    __shared__ int n_buf;
    constexpr int ROWS = KCAP > ADC_KCAP ? K5_WIDE_ROWS : K5_ROWS;
    // [ROWS * blockDim.x + 32]
    float* bd = reinterpret_cast<float*>(lists_i + nw * k);
    int* bi = reinterpret_cast<int*>(bd + ROWS * blockDim.x + 32);
    if (threadIdx.x == 0) n_buf = 0;
    __syncthreads();
    adc_block_select<KCAP>(codes, pids, wl, lists_d, lists_i, bd, bi, &n_buf,
                           lo, hi, m, C, k, od, oi);
    return;
  }
  __syncthreads();  // K4: lists of ADC_KCAP only
  for (long long base = lo + warp * 32; base < hi; base += nw * 32) {
    const long long p = base + lane;
    const bool in = p < hi && (!pids || pids[p] >= 0);
    const float dv = in ? adc_dist(wl, codes + p * m, m, C) : CUDART_INF_F;
    warp_merge_offer<ADC_KCAP>(rd, ri, k, dv, (int)p, in);
  }
  for (int s = 1; s < nw; s <<= 1) {
    __syncthreads();  // warp + s finished its list
    if ((warp & (2 * s - 1)) == 0 && warp + s < nw)
      warp_merge_list<ADC_KCAP>(rd, ri, lists_d + (warp + s) * k,
                                lists_i + (warp + s) * k, k);
  }
  if (warp == 0) adc_emit(rd, ri, k, od, oi, [](int r) { return r; });
}

// pids may be null: every row is live (K4 only). K4: one block of up to 8
// warps per lookup row, as many as shared memory holds beside the LUT, at
// k <= 128 only. K5 (fused): one block of K5_WARPS warps per lookup row,
// the lists' space (only warp 0's is used) and the candidate buffer beside
// the LUT; k <= 128 runs at KCAP 128, 128 < k <= 256 at KCAP 256.
int adcscan_run(bool fused, const void* codes, const void* pleaves,
                const void* pids, const void* lut, const void* qleaves,
                const void* q_start, void* out_d, void* out_i, int P, int Q,
                int n_lut, int m, int C, int k, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t lut_bytes = sizeof(float) * (size_t)m * C;
  const size_t list_bytes = (sizeof(float) + sizeof(int)) * (size_t)k;
  const size_t cap = 227 * 1024 - 64;  // H100 opt-in shared memory
  const bool wide = k > ADC_KCAP;
  if (P < 1 || Q < 1 || k < 1 || k > (fused ? WIDE_KCAP : ADC_KCAP) ||
      lut_bytes + list_bytes > cap || (fused && !pids))
    return (int)cudaErrorInvalidValue;
  int nw;
  size_t smem;
  if (fused) {
    nw = K5_WARPS;
    smem = lut_bytes + nw * list_bytes +
           (sizeof(float) + sizeof(int)) *
               (size_t)((wide ? K5_WIDE_ROWS : K5_ROWS) * nw * 32 + 32);
    if (smem > cap) return (int)cudaErrorInvalidValue;
  } else {
    const size_t fit = (cap - lut_bytes) / list_bytes;
    nw = fit < (size_t)(THREADS / 32) ? (int)fit : THREADS / 32;
    smem = lut_bytes + nw * list_bytes;
  }
  auto kernel = !fused ? adcscan_kernel<false, ADC_KCAP>
                       : wide ? adcscan_kernel<true, WIDE_KCAP>
                              : adcscan_kernel<true, ADC_KCAP>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<Q, nw * 32, smem, st>>>(
      (const uint8_t*)codes, (const int*)pleaves, (const int*)pids,
      (const float*)lut, (const int*)qleaves, (const long long*)q_start,
      (float*)out_d, (int*)out_i, P, n_lut, m, C, k);
  return (int)cudaGetLastError();
}

extern "C" int adcscan_launch(const void* codes, const void* pleaves,
                              const void* pids, const void* lut,
                              const void* qleaves, const void* q_start,
                              void* out_d, void* out_i, int P, int Q,
                              int n_lut, int m, int C, int k, void* stream) {
  return adcscan_run(false, codes, pleaves, pids, lut, qleaves, q_start, out_d,
                     out_i, P, Q, n_lut, m, C, k, stream);
}
