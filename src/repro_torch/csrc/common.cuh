// Device functions shared by the l2topk (K1), fusedscan (K2), l2nn (K3),
// adcscan (K4) and fusedadc (K5) kernels. K1 and K2 compute the partial
// distance in the SAME order of fp32 operations (one fmaf chain for
// ||p||^2 and one for q.p, over c = 0..d-1, then __fsub_rn(pn, 2 * dot)),
// K2 through the tile functions below and K1 one point row per lane; K4
// and K5 share the ADC distance. K1 and K4 merge candidates in batches
// (warp_merge_offer), which builds the lists K2's and K5's one-at-a-time
// insertion (warp_offer) builds. So the wave-sweep and the fused search
// paths agree bit for bit, dense and codes alike.
//
// Arithmetic contract (the plain versions in kernels/*/ref.py):
//   partial[q, p] = ||p||^2 - 2 * (q . p)     fp32, FMA chains over d
// The ||p||^2 and q.p sums run in order over d = 0..d-1 (one fmaf per
// term). On integer-valued data (quantized SIFT, d <= 128) every partial
// sum is an integer below 2^24, so the result is exact in any order and
// the kernels equal the plain versions bit for bit; on other data they
// agree within the reference's 2e-4 tolerance and stay within the fp32
// error bound of a float64 oracle (kernels/fp32_bound.py), which TF32 or
// bf16 inputs would break (integer data are exact in those too).
//
// ADC contract (kernels/adcscan/ref.py): d2[q, p] = sum_j lut[q, j, c_pj],
// fp32 adds in the order j = 0..m-1 starting from 0, with no product, so
// neither TF32 nor an FMA can enter and the kernels equal the plain
// versions bit for bit on any LUT.
//
// Selection contract: the k smallest by (distance, row) lexicographic,
// ties to the lower row, ascending -- what jax.lax.top_k on negated
// values gives. Rows are unique, so that order is total and the result
// does not depend on the order candidates arrive in. The list capacity
// KCAP (a multiple of 32, k <= KCAP) is a template parameter: each lane
// keeps KCAP / 32 registers while it shifts the list, so the dense kernels
// stay at 64 and only the codes kernels, whose k is the rerank depth,
// take 128.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rt {

constexpr int TQ = 64;          // query rows per block (K2's tiles)
constexpr int TP = 64;          // point rows per staged tile (K2)
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int QPITCH = TQ;      // row pitch of the transposed query tile
constexpr int PPITCH = TP + 4;  // row pitch of the transposed point tile
constexpr int DPITCH = TP + 1;  // row pitch of the distance tile
constexpr int MAX_D = 256;
constexpr int DENSE_KCAP = 64;  // k of K1 and K2 (kernels/l2topk/ops.py)
constexpr int ADC_KCAP = 128;   // k of K4 and K5: the rerank depth
constexpr unsigned FULL = 0xffffffffu;

// Same values as core/sentinels.py.
constexpr int PAD_TILE_POINT_LEAF = -9;
constexpr int PAD_TILE_QUERY_LEAF = -8;

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// Copy rows [row0, row0 + nvalid) of a row-major (., d) matrix into a
// transposed shared tile dst[c * pitch + r]; rows past nvalid are zero.
__device__ __forceinline__ void stage_rows_t(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             long long row0, int nvalid,
                                             int d, int pitch, int trows) {
  for (int idx = threadIdx.x; idx < trows * d; idx += THREADS) {
    int r = idx / d, c = idx - r * d;
    float v = r < nvalid ? src[(row0 + r) * (long long)d + c] : 0.f;
    dst[c * pitch + r] = v;
  }
}

// Sequential fp32 squared norm of column r of a transposed tile.
__device__ __forceinline__ float col_sq_norm(const float* __restrict__ t,
                                             int r, int d, int pitch) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) {
    float v = t[c * pitch + r];
    acc = fmaf(v, v, acc);
  }
  return acc;
}

// 4 x 4 dot products per thread between the query tile qs[d][QPITCH] and
// the point tile ps[d][PPITCH]: acc[i][j] = q[ty*4+i] . p[tx*4+j].
__device__ __forceinline__ void tile_dots(const float* __restrict__ qs,
                                          const float* __restrict__ ps, int d,
                                          float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float4 a = *reinterpret_cast<const float4*>(qs + c * QPITCH + ty * 4);
    float4 b = *reinterpret_cast<const float4*>(ps + c * PPITCH + tx * 4);
    float av[4] = {a.x, a.y, a.z, a.w};
    float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Write the masked partial-distance tile dt[q][p] = pn[p] - 2 q.p where the
// pair is allowed, +inf elsewhere. 2*x is exact in fp32, so this rounds
// once, as the plain version's `pn - 2.0 * dots` does.
template <typename Allow>
__device__ __forceinline__ void write_tile(float* __restrict__ dt,
                                           const float* __restrict__ pn,
                                           const float acc[4][4],
                                           Allow allow) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int q = ty * 4 + i, p = tx * 4 + j;
      float v = __fsub_rn(pn[p], 2.0f * acc[i][j]);
      dt[q * DPITCH + p] = allow(q, p) ? v : CUDART_INF_F;
    }
}

// Insert (cd, ci) into the ascending list rd/ri of k <= KCAP entries; the
// caller has checked that it beats the last entry. All 32 lanes of the
// warp call.
template <int KCAP>
__device__ __forceinline__ void warp_insert(float* rd, int* ri, int k,
                                            float cd, int ci) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    int p = base + lane;
    bool lt = p < k && lex_less(rd[p], ri[p], cd, ci);
    pos += __popc(__ballot_sync(FULL, lt));
  }
  float od[KCAP / 32];
  int oi[KCAP / 32];
#pragma unroll
  for (int t = 0; t < KCAP / 32; ++t) {
    int p = t * 32 + lane;
    if (p < k && p > pos) {
      od[t] = rd[p - 1];
      oi[t] = ri[p - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KCAP / 32; ++t) {
    int p = t * 32 + lane;
    if (p < k && p > pos) {
      rd[p] = od[t];
      ri[p] = oi[t];
    } else if (p == pos) {
      rd[p] = cd;
      ri[p] = ci;
    }
  }
  __syncwarp();
}

// Each lane offers one candidate (dv, row) when ok; the warp inserts every
// candidate that beats the current k-th entry. Candidates that stop
// qualifying as the list improves drop out without an insert.
template <int KCAP>
__device__ __forceinline__ void warp_offer(float* rd, int* ri, int k, float dv,
                                           int row, bool ok) {
  unsigned m = __ballot_sync(FULL, ok && lex_less(dv, row, rd[k - 1], ri[k - 1]));
  while (m) {
    int src = __ffs(m) - 1;
    float cd = __shfl_sync(FULL, dv, src);
    int ci = __shfl_sync(FULL, row, src);
    warp_insert<KCAP>(rd, ri, k, cd, ci);
    m &= ~(1u << src);
    m &= __ballot_sync(FULL, ok && lex_less(dv, row, rd[k - 1], ri[k - 1]));
  }
}

// Shared-memory layout of K2's search scan.
struct ScanSmem {
  float* qs;    // [d][QPITCH]  query tile, transposed
  float* ps;    // [d][PPITCH]  point tile, transposed
  float* pn;    // [TP]         point squared norms
  float* dt;    // [TQ][DPITCH] masked partial distances
  int* qlf;     // [TQ]
  int* plf;     // [TP]
  float* rd;    // [TQ][k]      running distances, ascending
  int* ri;      // [TQ][k]      running rows
  int* ranges;  // [4]          q leaf min/max, p leaf min/max (or row hull)
};

__host__ __device__ inline size_t scan_smem_bytes(int d, int k) {
  return sizeof(float) * ((size_t)d * QPITCH + (size_t)d * PPITCH + TP +
                          (size_t)TQ * DPITCH) +
         sizeof(int) * (TQ + TP) + (sizeof(float) + sizeof(int)) * TQ * k +
         sizeof(int) * 4;
}

__device__ inline ScanSmem scan_smem(void* base, int d, int k) {
  ScanSmem s;
  char* p = reinterpret_cast<char*>(base);
  s.qs = reinterpret_cast<float*>(p);
  p += sizeof(float) * d * QPITCH;
  s.ps = reinterpret_cast<float*>(p);
  p += sizeof(float) * d * PPITCH;
  s.pn = reinterpret_cast<float*>(p);
  p += sizeof(float) * TP;
  s.dt = reinterpret_cast<float*>(p);
  p += sizeof(float) * TQ * DPITCH;
  s.qlf = reinterpret_cast<int*>(p);
  p += sizeof(int) * TQ;
  s.plf = reinterpret_cast<int*>(p);
  p += sizeof(int) * TP;
  s.rd = reinterpret_cast<float*>(p);
  p += sizeof(float) * TQ * k;
  s.ri = reinterpret_cast<int*>(p);
  p += sizeof(int) * TQ * k;
  s.ranges = reinterpret_cast<int*>(p);
  return s;
}

// Stage the block's query tile and leaves, reset the running lists, and
// record the tile's [min, max] query leaf over its valid rows.
__device__ inline void scan_begin(const ScanSmem& s, const float* queries,
                                  const int* qleaves, long long q0, int nq,
                                  int d, int k) {
  stage_rows_t(s.qs, queries, q0, nq, d, QPITCH, TQ);
  if (threadIdx.x == 0) {
    s.ranges[0] = INT32_MAX;
    s.ranges[1] = INT32_MIN;
  }
  for (int t = threadIdx.x; t < TQ * k; t += THREADS) {
    s.rd[t] = CUDART_INF_F;
    s.ri[t] = -1;
  }
  __syncthreads();
  if (threadIdx.x < TQ) {
    int t = threadIdx.x;
    int lf = t < nq ? qleaves[q0 + t] : PAD_TILE_QUERY_LEAF;
    s.qlf[t] = lf;
    if (t < nq) {
      atomicMin(&s.ranges[0], lf);
      atomicMax(&s.ranges[1], lf);
    }
  }
  __syncthreads();
}

// Scan point rows [p_begin, p_end) against the staged query tile, folding
// every same-leaf pair into the running lists. A point tile whose valid
// leaf range is disjoint from the query tile's cannot hold a match and is
// skipped (the pl.when(overlap) test of the TPU fused kernel).
__device__ inline void scan_points(const ScanSmem& s, const float* points,
                                   const int* pleaves, long long p_begin,
                                   long long p_end, int nq, int d, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long pt = p_begin; pt < p_end; pt += TP) {
    const int np = (int)min((long long)TP, p_end - pt);
    __syncthreads();  // every thread has read the previous tile's ranges
    if (threadIdx.x == 0) {
      s.ranges[2] = INT32_MAX;
      s.ranges[3] = INT32_MIN;
    }
    __syncthreads();
    if (threadIdx.x < TP) {
      int t = threadIdx.x;
      int lf = t < np ? pleaves[pt + t] : PAD_TILE_POINT_LEAF;
      s.plf[t] = lf;
      if (t < np) {
        atomicMin(&s.ranges[2], lf);
        atomicMax(&s.ranges[3], lf);
      }
    }
    __syncthreads();
    if (s.ranges[2] > s.ranges[1] || s.ranges[0] > s.ranges[3]) continue;
    stage_rows_t(s.ps, points, pt, np, d, PPITCH, TP);
    __syncthreads();
    if (threadIdx.x < TP) s.pn[threadIdx.x] = col_sq_norm(s.ps, threadIdx.x, d, PPITCH);
    float acc[4][4];
    tile_dots(s.qs, s.ps, d, acc);
    __syncthreads();
    write_tile(s.dt, s.pn, acc, [&](int q, int p) {
      return q < nq && p < np && s.qlf[q] == s.plf[p];
    });
    __syncthreads();
    // 8 warps x 8 queries: each warp folds its queries' 64 candidates
    for (int qq = 0; qq < TQ / 8; ++qq) {
      int q = warp * (TQ / 8) + qq;
      if (q >= nq) break;
      float* rd = s.rd + q * k;
      int* ri = s.ri + q * k;
#pragma unroll
      for (int half = 0; half < TP / 32; ++half) {
        int p = half * 32 + lane;
        float dv = s.dt[q * DPITCH + p];
        warp_offer<DENSE_KCAP>(rd, ri, k, dv, (int)(pt + p),
                               p < np && dv < CUDART_INF_F);
      }
    }
    __syncthreads();
  }
}

// First / one-past-last index of v in the ascending array a[0, n).
__device__ __forceinline__ long long lower_bound_i32(const int* a, long long n,
                                                     int v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound_i32(const int* a, long long n,
                                                     int v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One round of a warp-wide bound search on the bound's range [*lo, *hi):
// the 32 lanes have sampled it every `step` entries, `before` is the
// lane's vote (its sample lies before the bound: a prefix of the lanes
// votes so, the array being sorted); narrows the range to one step, or to
// the bound itself (*lo == *hi).
__device__ __forceinline__ void warp_bound_narrow(bool before, long long step,
                                                  long long* lo,
                                                  long long* hi) {
  const int c = __popc(__ballot_sync(FULL, before));  // a prefix of lanes
  if (c == 0) {
    *hi = *lo;
  } else {
    *hi = min(*hi, *lo + c * step);
    *lo += (c - 1) * step + 1;
  }
}

// v's run [*lo, *hi) in the ascending a[0, n), with the whole warp: each
// round reads 32 samples of the remaining range at once, so P = 4096 takes
// 3 rounds of loads, not 12 dependent ones, and the lower bound's and the
// upper bound's rounds are interleaved, so that their loads are in flight
// together. All 32 lanes call, with the same arguments.
__device__ inline void warp_run_i32(const int* a, long long n, int v,
                                    long long* lo, long long* hi) {
  const int lane = threadIdx.x & 31;
  long long llo = 0, lhi = n, ulo = 0, uhi = n;  // the two bounds' ranges
  while (lhi - llo > 32 || uhi - ulo > 32) {
    const bool lw = lhi - llo > 32, uw = uhi - ulo > 32;
    const long long ls = (lhi - llo + 31) / 32, us = (uhi - ulo + 31) / 32;
    const long long li = llo + lane * ls, ui = ulo + lane * us;
    const bool lb = lw && li < lhi && a[li] < v;
    const bool ub = uw && ui < uhi && a[ui] <= v;
    if (lw) warp_bound_narrow(lb, ls, &llo, &lhi);  // warp-uniform branches
    if (uw) warp_bound_narrow(ub, us, &ulo, &uhi);
  }
  const long long li = llo + lane, ui = ulo + lane;
  const bool lb = li < lhi && a[li] < v;
  const bool ub = ui < uhi && a[ui] <= v;
  *lo = llo + __popc(__ballot_sync(FULL, lb));
  *hi = ulo + __popc(__ballot_sync(FULL, ub));
}

// ---- asynchronous copies (cp.async) into shared memory ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros, and no read, where
// !valid. src must be a readable address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sort one (d, row) pair per lane ascending by (d, row) across the warp
// (bitonic network over shuffles).
__device__ __forceinline__ void warp_sort32(float& d, int& r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float od = __shfl_xor_sync(FULL, d, stride);
      const int orow = __shfl_xor_sync(FULL, r, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      const bool other_less = lex_less(od, orow, d, r);
      if (keep_min ? other_less : !other_less) {
        d = od;
        r = orow;
      }
    }
  }
}

// warp_offer's result in one step for up to 32 candidates: the candidates
// that beat the k-th entry are sorted across the warp and merged into the
// ascending list rd/ri of k <= KCAP entries, each entry and candidate
// moving straight to its rank in the union (keys (distance, row) are
// unique), truncated to k. The list equals the one warp_offer builds; the
// critical path is a sort and two searches instead of one insertion a
// candidate. All 32 lanes of the warp call.
template <int KCAP>
__device__ inline void warp_merge_offer(float* rd, int* ri, int k, float dv,
                                        int row, bool ok) {
  const int lane = threadIdx.x & 31;
  ok = ok && lex_less(dv, row, rd[k - 1], ri[k - 1]);
  const unsigned any = __ballot_sync(FULL, ok);
  if (!any) return;
  const int n = __popc(any);
  float cd = ok ? dv : CUDART_INF_F;
  int cr = ok ? row : INT32_MAX;
  warp_sort32(cd, cr);  // the n candidates in lanes 0..n-1
  int before = INT32_MAX;  // list entries before this lane's candidate
  if (lane < n) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lex_less(rd[mid], ri[mid], cd, cr)) lo = mid + 1; else hi = mid;
    }
    before = lo;
  }
  float od[KCAP / 32];
  int oi[KCAP / 32], moved[KCAP / 32];
#pragma unroll
  for (int t = 0; t < KCAP / 32; ++t) {
    const int p = t * 32 + lane;
    if (p < k) {
      od[t] = rd[p];
      oi[t] = ri[p];
    }
    // candidates ahead of entry p: those with before <= p (ascending in lane)
    int c = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(FULL, before, c + step - 1) <= p) c += step;
    if (__shfl_sync(FULL, before, c) <= p) ++c;
    moved[t] = p + c;
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KCAP / 32; ++t) {
    const int p = t * 32 + lane;
    if (p < k && moved[t] < k) {
      rd[moved[t]] = od[t];
      ri[moved[t]] = oi[t];
    }
  }
  if (lane < n && lane + before < k) {
    rd[lane + before] = cd;
    ri[lane + before] = cr;
  }
  __syncwarp();
}

// ---- ADC (K4, K5): a query row's LUT in shared memory; K5 gives each
// query row one warp (the per-warp layout below), K4 one block ----

// Shared-memory bytes of one warp of an ADC kernel: the query's m * C LUT,
// then its running list of k distances and k rows.
__host__ __device__ inline size_t adc_warp_smem_bytes(int lut_n, int k) {
  return sizeof(float) * ((size_t)lut_n + k) + sizeof(int) * (size_t)k;
}

// Warps per block of an ADC kernel: at most THREADS / 32, as many as one
// block's shared memory holds; 0 when not even one warp fits.
inline int adc_warps_per_block(int lut_n, int k) {
  const size_t per_warp = adc_warp_smem_bytes(lut_n, k);
  const size_t fit = (size_t)(227 * 1024 - 64) / per_warp;  // H100 opt-in
  return fit < (size_t)(THREADS / 32) ? (int)fit : THREADS / 32;
}

// The calling warp's LUT and list in its block's dynamic shared memory.
__device__ inline void adc_warp_smem(void* base, int lut_n, int k,
                                     float** lut, float** rd, int** ri) {
  char* p = reinterpret_cast<char*>(base) +
            (threadIdx.x >> 5) * adc_warp_smem_bytes(lut_n, k);
  *lut = reinterpret_cast<float*>(p);
  *rd = *lut + lut_n;
  *ri = reinterpret_cast<int*>(*rd + k);
}

__device__ inline void adc_reset_list(float* rd, int* ri, int k) {
  for (int j = threadIdx.x & 31; j < k; j += 32) {
    rd[j] = CUDART_INF_F;
    ri[j] = -1;
  }
  __syncwarp();
}

__device__ inline void adc_stage_lut(float* dst, const float* __restrict__ src,
                                     int lut_n) {
  for (int j = threadIdx.x & 31; j < lut_n; j += 32) dst[j] = src[j];
  __syncwarp();
}

// sum_j lut[j * C + code[j]] in fp32, in the order j = 0..m-1 from 0 (the
// plain version's loop); __fadd_rn keeps the compiler from reassociating.
__device__ __forceinline__ float adc_dist(const float* lut,
                                          const uint8_t* __restrict__ code,
                                          int m, int C) {
  float acc = 0.f;
  for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, lut[j * C + code[j]]);
  return acc;
}

// One warp offers every code row p in [r0, r1) with ok(p) to its sorted
// list of k <= ADC_KCAP, 32 rows at a time, lane i taking row base + i.
template <typename Ok>
__device__ inline void adc_scan_rows(float* rd, int* ri, int k,
                                     const float* lut,
                                     const uint8_t* __restrict__ codes, int m,
                                     int C, long long r0, long long r1, Ok ok) {
  const int lane = threadIdx.x & 31;
  for (long long base = r0; base < r1; base += 32) {
    const long long p = base + lane;
    const bool in = p < r1 && ok(p);
    const float dv = in ? adc_dist(lut, codes + p * m, m, C) : CUDART_INF_F;
    warp_offer<ADC_KCAP>(rd, ri, k, dv, (int)p, in);
  }
}

// Write a warp's list: distances, and rows through map(row) (-1 where the
// distance is inf, that is where fewer than k rows matched).
template <typename Map>
__device__ inline void adc_emit(const float* rd, const int* ri, int k,
                                float* out_d, int* out_i, Map map) {
  for (int j = threadIdx.x & 31; j < k; j += 32) {
    const float dv = rd[j];
    out_d[j] = dv;
    out_i[j] = dv < CUDART_INF_F ? map(ri[j]) : -1;
  }
}

}  // namespace rt
