// Wide lists: the scan kernels' function for any k (ROADMAP P7).
//
// K1 (l2topk.cu) and K2 (fusedscan.cu) keep their lists in registers while
// they shift them, at a capacity of 64; K4 and K5 (adcscan.cu) at 128. The
// reference serves any k <= block_rows, and a codes search's rerank depth
// is k itself past 128 (core/engine/plan.py default_rerank). The wrappers
// (kernels/l2topk/ops.py route) split the range past those capacities in
// two:
//  * 64 / 128 < k <= 256 ("wide_lists", the range real searches use: a
//    k-NN list of 100 for copy-detection voting, a rerank depth of 256):
//    the scan kernels K1, K2 and K5 themselves, instantiated with lists of
//    WIDE_KCAP = 256 (their leaf runs, K1's 4-SM clusters, K2's leaf-group
//    tiles and long-run clusters, cp.async staging at a conflict-free
//    pitch, K2's and K5's buffered merges behind a gate on the k-th
//    entry), each warp's list of k in shared memory shifting through 8
//    registers a lane (4 for k <= 128), and the lists of a block's warps
//    and of a cluster's blocks folded by rank with the whole block
//    (common.cuh block_merge_pairs) instead of 32 entries a merge. See
//    the headers of l2topk.cu, fusedscan.cu and adcscan.cu.
//  * k > 256 ("block_list"), and K4 past 128: this file's kernel, one list
//    a block. K4 has no wide range: with lists of 256 folded by rank it
//    gained nothing resolved over this kernel at rerank 256 (adcscan.cu).
// The split sits at 256 because a list of 256 still shifts through 8
// registers a lane without spilling (nvcc -Xptxas -v, sm_90a): K1 at
// KCAP 256 80 registers (4 B spilled, as K1 spills 24-36 B at 64), K2's
// kernels 133-136 (none), K5 104 (none); past it the register slots would
// double again. At the P7 phase's calls (chip_smoke.py and
// scripts/wide_segsum_ab.py, this kernel's times in parentheses; H100 80GB
// HBM3, 700.00 W): K1 at k = 100 0.0262-0.0264 ms a wave (0.0685-0.0689),
// K2 5.07-5.19 ms (10.86-10.97), K5 at rerank 256 1.469-1.476 (2.88-2.91);
// K4 at rerank 256 runs this kernel, 0.0324-0.0328 ms a wave.
//
// This kernel: one block of 256 threads per output row. The block finds
// its leaf's run [lo, hi) in the sorted point leaves with a warp-wide
// search (common.cuh warp_run_i32, as K1 and K4 do; a row whose leaf lies
// outside [leaves[0], leaves[P - 1]] gets its empty list at once), stages
// its query row or its m x C LUT in shared memory, and walks the run 256
// rows a batch, one row a thread: the distance arithmetic of K1 (one fmaf
// chain for ||p||^2 and one for q.p, c = 0..d-1, then
// __fsub_rn(pn, 2 * dot)) or of K4 (adc_dist, j = 0..m-1). The batch's
// candidates that beat the list's k-th entry are sorted across the block
// (a bitonic sort in each warp, then each candidate's rank among the other
// warps' by binary search) and merged into the block's sorted (distance,
// row) list of k by rank, as warp_merge_offer does at warp width: every
// entry moves to its own index plus the number of entries on the other
// side that precede it, into a second buffer. Keys are unique, so the
// list is the plain version's whatever the batching, and K1/K2 and K4/K5
// stay bit-identical at every k. The two buffers of the list live in
// shared memory up to k = 4096 (64 KiB), else in the output row and a
// scratch row that the wrapper allocates. The ids: K2's rule (a kept row
// whose id is < 0 is emitted as -1 / inf) where map_ids is given; ADC
// rows with id < 0 are skipped in the scan where skip_ids is given
// (tombstones, K4 and K5). 48 registers (58 in the float4 dense form), no
// spills (nvcc -Xptxas -v for sm_90a).
//
// Bound on the H100: the same bytes as the scan kernels (the run's rows
// and the query row or LUT, once each). Each row is read by the block of
// every lookup row of its leaf, from L2 after the first; a thread reads
// its own row, so the loads are not coalesced. It serves K4's rerank
// depths past 128 and every k past 256 (chip_smoke.py's P7 phase runs it
// at k = 512 on both paths, dense and codes); it is kept simple and right.
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; it sets its shared-memory size on every launch.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int W_THREADS = 256;
constexpr int W_WARPS = W_THREADS / 32;
constexpr int W_SMEM_K = 4096;  // lists in shared memory up to this k

// Dense rows: K1's fmaf chains over c = 0..d-1 against the staged query.
template <bool VEC>
struct DenseRows {
  const float* __restrict__ points;
  const float* __restrict__ queries;
  int d;
  __device__ int staged() const { return d; }
  __device__ const float* stage_src(long long q) const {
    return queries + q * d;
  }
  __device__ DenseRows from(long long s) const {
    return DenseRows{points + s * d, queries, d};
  }
  __device__ float dist(const float* qs, long long p) const {
    const float* row = points + p * d;
    float pn = 0.f, dot = 0.f;
    if (VEC) {
      for (int c = 0; c < d; c += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(row + c);
        const float4 qv = *reinterpret_cast<const float4*>(qs + c);
        pn = fmaf(pv.x, pv.x, pn);
        dot = fmaf(qv.x, pv.x, dot);
        pn = fmaf(pv.y, pv.y, pn);
        dot = fmaf(qv.y, pv.y, dot);
        pn = fmaf(pv.z, pv.z, pn);
        dot = fmaf(qv.z, pv.z, dot);
        pn = fmaf(pv.w, pv.w, pn);
        dot = fmaf(qv.w, pv.w, dot);
      }
    } else {
      for (int c = 0; c < d; ++c) {
        const float v = row[c];
        pn = fmaf(v, v, pn);
        dot = fmaf(qs[c], v, dot);
      }
    }
    return __fsub_rn(pn, 2.0f * dot);
  }
};

// ADC rows: K4's sum of m LUT entries gathered by the row's uint8 codes.
struct AdcRows {
  const uint8_t* __restrict__ codes;
  const float* __restrict__ lut;
  int m, C;
  __device__ int staged() const { return m * C; }
  __device__ const float* stage_src(long long q) const {
    return lut + q * (long long)(m * C);
  }
  __device__ AdcRows from(long long s) const {
    return AdcRows{codes + s * m, lut, m, C};
  }
  __device__ float dist(const float* lt, long long p) const {
    return adc_dist(lt, codes + p * m, m, C);
  }
};

// Output row q: lookup row *q_start + q of n_q (the query or LUT table).
// The P point rows start at row *p_start of the arrays (p_start may be
// null: row 0), and rows are reported relative to it.
template <class Rows>
__global__ void __launch_bounds__(W_THREADS)
wide_kernel(Rows rows, const int* __restrict__ pleaves,
            const int* __restrict__ skip_ids, const int* __restrict__ map_ids,
            const int* __restrict__ qleaves,
            const long long* __restrict__ q_start, long long n_q,
            const long long* __restrict__ p_start,
            float* out_d, int* out_i, float* scratch_d, int* scratch_i, int P,
            int k) {
  if (p_start) {
    const long long s = *p_start;
    rows = rows.from(s);
    pleaves += s;
    if (skip_ids) skip_ids += s;
    if (map_ids) map_ids += s;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float wd[W_THREADS], cd[W_THREADS];  // warp-sorted, block-sorted
  __shared__ int wr[W_THREADS], cr[W_THREADS];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int q = blockIdx.x;
  float* od = out_d + (size_t)q * k;
  int* oi = out_i + (size_t)q * k;
  const long long qg = (q_start ? *q_start : 0) + q;
  long long lo = 0, hi = 0;  // every warp finds the same run
  if (qg < n_q) {
    const int ql = qleaves[qg];
    if (ql >= pleaves[0] && ql <= pleaves[P - 1])
      warp_run_i32(pleaves, P, ql, &lo, &hi);
  }
  if (lo >= hi) {  // block-uniform: no point row shares the leaf
    for (int j = t; j < k; j += W_THREADS) {
      od[j] = CUDART_INF_F;
      oi[j] = -1;
    }
    return;
  }
  float* stg = reinterpret_cast<float*>(smem_raw);  // the query row or LUT
  const int ns = rows.staged();
  float *Ld, *Nd;  // the list, and the buffer the next merge writes
  int *Li, *Ni;
  if (k <= W_SMEM_K) {
    Ld = stg + ((ns + 3) & ~3);
    Nd = Ld + k;
    Li = reinterpret_cast<int*>(Nd + k);
    Ni = Li + k;
  } else {
    Ld = od;
    Li = oi;
    Nd = scratch_d + (size_t)q * k;
    Ni = scratch_i + (size_t)q * k;
  }
  const float* src = rows.stage_src(qg);
  for (int j = t; j < ns; j += W_THREADS) stg[j] = src[j];
  for (int j = t; j < k; j += W_THREADS) {
    Ld[j] = CUDART_INF_F;
    Li[j] = -1;
  }
  __syncthreads();
  for (long long base = lo; base < hi; base += W_THREADS) {
    const long long p = base + t;
    const bool in = p < hi && (!skip_ids || skip_ids[p] >= 0);
    const float dv = in ? rows.dist(stg, p) : CUDART_INF_F;
    const bool ok = in && lex_less(dv, (int)p, Ld[k - 1], Li[k - 1]);
    const int n = __syncthreads_count(ok);
    if (n == 0) continue;  // block-uniform
    float sd = ok ? dv : CUDART_INF_F;  // every ok candidate is finite
    int sr = ok ? (int)p : INT32_MAX;
    warp_sort32(sd, sr);
    wd[t] = sd;
    wr[t] = sr;
    __syncthreads();
    if (sd < CUDART_INF_F) {  // its rank among the n: its lane plus the
      int rank = lane;       // other warps' candidates before it
      for (int w = 0; w < W_WARPS; ++w)
        if (w != warp)
          rank += count_before(wd + 32 * w, wr + 32 * w, 32, sd, sr, false);
      cd[rank] = sd;
      cr[rank] = sr;
    }
    __syncthreads();
    for (int e = t; e < k; e += W_THREADS) {
      const float dv2 = Ld[e];
      const int r2 = Li[e];
      const int to = e + count_before(cd, cr, n, dv2, r2, false);
      if (to < k) {
        Nd[to] = dv2;
        Ni[to] = r2;
      }
    }
    if (t < n) {
      const int to = t + count_before(Ld, Li, k, cd[t], cr[t], false);
      if (to < k) {
        Nd[to] = cd[t];
        Ni[to] = cr[t];
      }
    }
    __syncthreads();
    float* td = Ld;  // the merged list is the list now
    int* ti = Li;
    Ld = Nd;
    Li = Ni;
    Nd = td;
    Ni = ti;
  }
  for (int e = t; e < k; e += W_THREADS) {
    const float dv = Ld[e];
    const int r = Li[e];
    const int id = dv < CUDART_INF_F ? (map_ids ? map_ids[r] : r) : -1;
    od[e] = id >= 0 ? dv : CUDART_INF_F;
    oi[e] = id >= 0 ? id : -1;
  }
}

template <class Rows>
int wide_launch(const Rows& rows, const int* pleaves, const int* skip_ids,
                const int* map_ids, const int* qleaves,
                const long long* q_start, long long n_q,
                const long long* p_start, float* out_d,
                int* out_i, float* scratch_d, int* scratch_i, int P, int Q,
                int k, cudaStream_t st, int staged) {
  if (P < 1 || Q < 1 || k < 1 || k > P || (k > W_SMEM_K && !scratch_d))
    return (int)cudaErrorInvalidValue;
  const size_t lists = k <= W_SMEM_K ? 4 * sizeof(float) * (size_t)k : 0;
  const size_t smem = sizeof(float) * (size_t)((staged + 3) & ~3) + lists;
  if (smem > 227 * 1024 - 2 * W_THREADS * 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wide_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wide_kernel<Rows><<<Q, W_THREADS, smem, st>>>(
      rows, pleaves, skip_ids, map_ids, qleaves, q_start, n_q, p_start, out_d,
      out_i, scratch_d, scratch_i, P, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Dense: out row q is query row q. map_ids may be null (rows out, K1's
// call) or the shard's ids (K2's call). p_start may be null (points from
// row 0) or a device int64, the first of the P rows (K1's query tiles).
// scratch_d/_i: (Q, k) each, needed only for k > 4096 (else null).
extern "C" int l2topk_wide_launch(const void* points, const void* pleaves,
                                  const void* map_ids, const void* queries,
                                  const void* qleaves, const void* p_start,
                                  void* out_d, void* out_i,
                                  void* scratch_d, void* scratch_i, int P,
                                  int Q, int d, int k, void* stream) {
  if (d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // float4 reads need 16-byte aligned rows
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  const int* pl = (const int*)pleaves;
  const int* mi = (const int*)map_ids;
  const int* ql = (const int*)qleaves;
  const long long* ps = (const long long*)p_start;
  if (vec)
    return wide_launch(DenseRows<true>{(const float*)points, (const float*)queries, d},
                       pl, nullptr, mi, ql, nullptr, Q, ps, (float*)out_d,
                       (int*)out_i, (float*)scratch_d, (int*)scratch_i, P, Q, k,
                       st, d);
  return wide_launch(DenseRows<false>{(const float*)points, (const float*)queries, d},
                     pl, nullptr, mi, ql, nullptr, Q, ps, (float*)out_d, (int*)out_i,
                     (float*)scratch_d, (int*)scratch_i, P, Q, k, st, d);
}

// ADC: out row q is LUT row *q_start + q (q_start may be null) of n_lut.
// skip_ids: rows with id < 0 never match (null: every row is live);
// map_ids: emit ids (K5's call) instead of rows (null, K4's call).
extern "C" int adctopk_wide_launch(const void* codes, const void* pleaves,
                                   const void* skip_ids, const void* map_ids,
                                   const void* lut, const void* qleaves,
                                   const void* q_start, void* out_d,
                                   void* out_i, void* scratch_d,
                                   void* scratch_i, int P, int Q, int n_lut,
                                   int m, int C, int k, void* stream) {
  if (m < 1 || C < 1) return (int)cudaErrorInvalidValue;
  return wide_launch(AdcRows{(const uint8_t*)codes, (const float*)lut, m, C},
                     (const int*)pleaves, (const int*)skip_ids,
                     (const int*)map_ids, (const int*)qleaves,
                     (const long long*)q_start, n_lut, nullptr, (float*)out_d,
                     (int*)out_i, (float*)scratch_d, (int*)scratch_i, P, Q, k,
                     reinterpret_cast<cudaStream_t>(stream), m * C);
}
