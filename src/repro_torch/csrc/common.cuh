// Device functions shared by the l2topk (K1), fusedscan (K2), l2nn (K3),
// adcscan (K4, and K5, which is K4's kernel over the whole shard) and
// widetopk kernels. K1 and K2 compute the partial distance in the SAME
// order of fp32 operations (one fmaf chain for ||p||^2 and one for q.p,
// over c = 0..d-1, then __fsub_rn(pn, 2 * dot)), one point row per lane
// staged through shared memory (load_chunk); the wide kernels
// (widetopk.cu) keep that order too, and the ADC kernels share adc_dist.
// Every list update merges a batch of candidates at once by rank
// (warp_merge_offer; the wide kernels at block width); K2 and K5 first
// gather the candidates that beat the k-th entry in a buffer of 32 and
// merge it when it fills (warp_buffered_offer, K5's block buffer). So the
// wave-sweep and the fused search paths agree bit for bit, dense and codes
// alike, at every k.
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
// KCAP (a multiple of 32, k <= KCAP) of the register-shifted lists is a
// template parameter: each lane keeps KCAP / 32 registers while it shifts
// a list, so the dense kernels run at 64 and the codes kernels, whose k
// is the rerank depth, at 128. The same kernels, instantiated at
// WIDE_KCAP = 256 (whose lists of k <= 128 shift through 128), serve the
// wide range up to 256 (every rerank depth and k-NN list a search asks
// for in practice); there the lists of a block's warps, and of a
// cluster's blocks, are folded by rank with the whole block
// (block_merge_pairs), not 32 entries at a time by one warp. A k past 256
// (any k up to the rows scanned) goes to widetopk.cu's block-list kernel.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rt {

constexpr int THREADS = 256;    // K1, K3, K4: 8 warps
constexpr int MAX_D = 256;
constexpr int DENSE_KCAP = 64;  // largest k of K1 and K2 (kernels/l2topk/ops.py)
constexpr int ADC_KCAP = 128;   // largest k of K4 and K5: the rerank depth
constexpr int WIDE_KCAP = 256;  // the wide range's lists (kernels/l2topk/ops.py)
constexpr unsigned FULL = 0xffffffffu;

// Function attributes and occupancy are per device, and a launch runs on
// the current device (the wrapper makes its tensors' device current). A
// launcher that sets or reads them once keeps one slot per device,
// indexed by current_device(), which is -1 past MAX_DEVICES.
constexpr int MAX_DEVICES = 64;
inline int current_device() {
  int d = 0;
  if (cudaGetDevice(&d) != cudaSuccess || d < 0 || d >= MAX_DEVICES) return -1;
  return d;
}

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
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

// Stage a chunk of 32 point rows from row0 into buf (row pitch PITCH
// floats), columns col0 .. col0 + CK - 1, with the calling warp: rows past
// hi and columns past d land as zeros, which add exact zeros to the fmaf
// chains. VEC: 16-byte copies (d % 4 == 0 and 16-byte aligned rows).
template <bool VEC, int CK, int PITCH>
__device__ __forceinline__ void load_chunk(float* buf,
                                           const float* __restrict__ points,
                                           long long row0, long long hi,
                                           int col0, int d) {
  const int lane = threadIdx.x & 31;
  constexpr int F4 = CK / 4;  // 16-byte pieces of a chunk row
  if (VEC) {
#pragma unroll
    for (int i = 0; i < F4; ++i) {
      const int f = lane + 32 * i, r = f / F4, c = (f % F4) * 4;
      const long long row = row0 + r;
      const bool ok = row < hi && col0 + c < d;
      cp_async16(buf + r * PITCH + c, ok ? points + row * d + col0 + c : points,
                 ok);
    }
  } else {
    for (int r = 0; r < 32; ++r)
      for (int c = lane; c < CK; c += 32) {
        const long long row = row0 + r;
        const bool ok = row < hi && col0 + c < d;
        cp_async4(buf + r * PITCH + c, ok ? points + row * d + col0 + c : points,
                  ok);
      }
  }
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

// Offer up to 32 candidates, one a lane where ok: those that beat the
// k-th entry are sorted across the warp and merged into the ascending list
// rd/ri of k <= KCAP entries, each entry and candidate moving straight to
// its rank in the union (keys (distance, row) are unique), truncated to k.
// The list equals the one that inserting the candidates one at a time
// would build; the critical path is a sort and two searches instead of one
// insertion a candidate. All 32 lanes of the warp call.
template <int KCAP>
__device__ inline void warp_merge_offer(float* rd, int* ri, int k, float dv,
                                        int row, bool ok) {
  if constexpr (KCAP > ADC_KCAP) {
    // the wide lists: a list of k <= KCAP / 2 shifts through half the
    // registers. The register slots' shuffle searches below are
    // independent, so the card interleaves them; a guard on each (to skip
    // the slots past k) would put them in a row.
    if (k <= KCAP / 2) {
      warp_merge_offer<KCAP / 2>(rd, ri, k, dv, row, ok);
      return;
    }
  }
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

// Offer one candidate a lane where ok, as warp_merge_offer does, through
// the warp's buffer bd/bi of up to 32 candidates (*nb of them, the same in
// every lane): a candidate that beats the k-th entry waits in the buffer,
// which is merged only when it would overflow (and by warp_flush at the
// end), so that a merge takes many candidates, not the few of one step.
// The list and the buffer together hold what the k smallest offered need;
// after warp_flush the list is the one warp_merge_offer builds.
template <int KCAP>
__device__ inline void warp_buffered_offer(float* rd, int* ri, int k,
                                           float* bd, int* bi, int* nb,
                                           float dv, int row, bool ok) {
  const int lane = threadIdx.x & 31;
  ok = ok && lex_less(dv, row, rd[k - 1], ri[k - 1]);
  unsigned m = __ballot_sync(FULL, ok);
  if (!m) return;
  int n = *nb;
  if (n + __popc(m) > 32) {
    warp_merge_offer<KCAP>(rd, ri, k, lane < n ? bd[lane] : CUDART_INF_F,
                           lane < n ? bi[lane] : -1, lane < n);
    n = 0;
    ok = ok && lex_less(dv, row, rd[k - 1], ri[k - 1]);
    m = __ballot_sync(FULL, ok);
  }
  if (ok) {
    const int at = n + __popc(m & ((1u << lane) - 1));
    bd[at] = dv;
    bi[at] = row;
  }
  __syncwarp();
  if (lane == 0) *nb = n + __popc(m);
  __syncwarp();
}

// Merge the warp's buffered candidates into its list and empty the buffer.
template <int KCAP>
__device__ inline void warp_flush(float* rd, int* ri, int k, float* bd,
                                  int* bi, int* nb) {
  const int lane = threadIdx.x & 31;
  const int n = *nb;
  if (n)
    warp_merge_offer<KCAP>(rd, ri, k, lane < n ? bd[lane] : CUDART_INF_F,
                           lane < n ? bi[lane] : -1, lane < n);
  __syncwarp();
  if (lane == 0) *nb = 0;
  __syncwarp();
}

// Fold the sorted list (sd, si) of k entries into the warp's sorted list
// rd/ri of k <= KCAP entries, 32 entries a step.
template <int KCAP>
__device__ inline void warp_merge_list(float* rd, int* ri, const float* sd,
                                       const int* si, int k) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < k; c += 32) {
    const int j = c + lane;
    const float dv = j < k ? sd[j] : CUDART_INF_F;
    warp_merge_offer<KCAP>(rd, ri, k, dv, j < k ? si[j] : -1,
                           dv < CUDART_INF_F);
  }
}

// Entries of the ascending (d, r) array [0, n) before (dv, rv); with
// or_equal, also an entry equal to it.
__device__ __forceinline__ int count_before(const float* d, const int* r,
                                            int n, float dv, int rv,
                                            bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = or_equal ? !lex_less(dv, rv, d[mid], r[mid])
                                 : lex_less(d[mid], r[mid], dv, rv);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int FOLD_LISTS = 32;  // most lists a block folds at once

// The finite entries of each of the n_lists sorted lists of k entries (at
// src(l) in sd/si) into n[l], with the block: the empty (inf, -1) entries
// fill a list's tail. The caller synchronises the block after.
template <class Src>
__device__ inline void block_count_lists(const float* sd, const int* si,
                                         Src src, int n_lists, int k, int* n) {
  for (int l = threadIdx.x; l < n_lists; l += blockDim.x)
    n[l] = count_before(sd + src(l), si + src(l), k, CUDART_INF_F, -1, false);
}

// Fold n_lists sorted (distance, row) lists of k entries, n_in[l] of them
// finite, into (n_lists + 1) / 2 lists of the k smallest of each pair,
// with the whole block: lists 2p and 2p + 1 (at src(2p), src(2p + 1) in
// sd/si) into list p (at dst(p) in dd/di), its finite count into n_out[p];
// an odd last list is copied. A finite entry's place is its index plus
// the other list's finite entries before it (rows are unique, so no two
// tie), found by a binary search of that list's finite prefix; an empty
// entry i of the first list lands at i plus the second's finite count,
// which fills the merged list's tail, and the second's empty entries land
// past k. So the first k places are each written once. The lists must not
// overlap the destination; the caller synchronises the block before and
// after.
template <class Src, class Dst>
__device__ inline void block_merge_pairs(const float* sd, const int* si,
                                         Src src, const int* n_in, float* dd,
                                         int* di, Dst dst, int* n_out,
                                         int n_lists, int k) {
  const int n_pairs = (n_lists + 1) / 2;
  for (int e = threadIdx.x; e < n_pairs * 2 * k; e += blockDim.x) {
    const int p = e / (2 * k), j = e - p * 2 * k;
    const bool second = j >= k, alone = 2 * p + 1 >= n_lists;
    const int i = second ? j - k : j;
    const int na = n_in[2 * p], nb = alone ? 0 : n_in[2 * p + 1];
    if (j == 0) n_out[p] = min(k, na + nb);
    if (second ? i >= nb : i >= na) {
      if (!second && i + nb < k) {  // an empty entry: the merged list's tail
        dd[dst(p) + i + nb] = CUDART_INF_F;
        di[dst(p) + i + nb] = -1;
      }
      continue;
    }
    const int own = src(2 * p + second);
    const float dv = sd[own + i];
    const int rv = si[own + i];
    int to = i;
    if (!alone) {
      const int other = src(2 * p + !second);
      to += count_before(sd + other, si + other, second ? na : nb, dv, rv,
                         false);
    }
    if (to < k) {
      dd[dst(p) + to] = dv;
      di[dst(p) + to] = rv;
    }
  }
}

// Fold the n_lists <= FOLD_LISTS lists of k entries at list * k in
// (ad, ai) into one, through room for (n_lists + 1) / 2 lists at (bd, bi),
// with the whole block. Returns whether the folded list is at bd (else
// ad). The caller synchronises the block before; the result is
// synchronised.
__device__ inline bool block_fold_lists(float* ad, int* ai, float* bd, int* bi,
                                        int n_lists, int k) {
  __shared__ int fold_n[2][FOLD_LISTS];  // the lists' finite counts
  const auto at = [k](int l) { return l * k; };
  block_count_lists(ad, ai, at, n_lists, k, fold_n[0]);
  __syncthreads();
  bool in_b = false;
  while (n_lists > 1) {
    if (in_b)
      block_merge_pairs(bd, bi, at, fold_n[1], ad, ai, at, fold_n[0], n_lists, k);
    else
      block_merge_pairs(ad, ai, at, fold_n[0], bd, bi, at, fold_n[1], n_lists, k);
    __syncthreads();
    in_b = !in_b;
    n_lists = (n_lists + 1) / 2;
  }
  return in_b;
}

// ---- ADC (K4, K5): a query row's LUT and lists in shared memory ----

__device__ inline void adc_reset_list(float* rd, int* ri, int k) {
  for (int j = threadIdx.x & 31; j < k; j += 32) {
    rd[j] = CUDART_INF_F;
    ri[j] = -1;
  }
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
