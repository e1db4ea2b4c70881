// segsum: the segment sum of weighted gathered rows behind GIN's message
// passing, deterministic, on the CUDA cores.
//
// Replaces no TPU kernel: the reference aggregates with XLA's gather and
// scatter-add (jax.ops.segment_sum over h[src] * edge_w,
// src/repro/models/gnn.py:62-66), which on the card adds with atomics in
// no fixed order and holds an (E, d) message tensor. Computes
// kernels/segsum/ref.py on a SegmentCSR (kernels/segsum/ops.py):
//   out[r, c] = sum over e in [indptr[r], indptr[r+1]) of w[e] * h[cols[e], c]
// every product rounded (__fmul_rn) and added in fp32 (__fadd_rn), so no
// FMA contracts them, as the plain version's product then index_add_ does.
// GIN's forward runs it on the edges sorted by destination, its backward
// on the same edges sorted by source (the transpose).
//
// Bound on the H100: each edge costs 2 d operations against d gathered
// floats, so the kernel is bound by bytes. Counted once (each input read
// once, each output written once): h, cols, w, the work items and out;
// at ogb_products' scale (61.9M edges, 2.45M nodes, d = 64) 1.75 GB, 0.52
// ms at 3.35 TB/s. The gathered rows are 15.8 GB there, so the kernel's
// real floor is the random 256-byte row reads, not the bound.
//
// Design: a row's edges split into chunks of at most SEG_CHUNK (the
// wrapper's work items: row, first edge, end, partial slot). One warp takes
// an item and 32 J columns (grid.y covers d), lane l holding columns
// c0 + l + 32 j; the item's (col, w) pairs are loaded 32 at a time, one a
// lane, and broadcast by shuffles; the gathered row reads of a warp are
// 128 contiguous bytes. A row of one chunk writes its output directly
// (from 0, in edge order: the plain version's sum bit for bit); a longer
// row's chunks write partial rows. So a power-law hub (458,564 out-edges in
// ogb_products' random graph, the backward's longest row) spreads over
// 1,792 warps.
//
// The long rows' partial rows are added as a tree of fixed shape
// (segsum_tree_kernel, one launch a level): each group of up to 32
// consecutive nodes of a level (kernels/segsum/ops.py tree_plan) is added
// in order by one warp into a node of the next level, until one node, the
// output row, remains. The plan depends on a row's partial count alone,
// never on the grid or the device, so every output has one order of adds
// and a rerun gives the same bits. The padding row of ogb_products'
// forward (1,241,246 edges into node 0: 4,849 partial rows) takes 3 levels
// of 152, 5 and 1 warps, not 4,849 adds in a row on one warp. No atomics,
// no (E, d) tensor.
//
// Measured (scripts/wide_segsum_ab.py, NVIDIA H100 80GB HBM3, 700.00 W, at
// ogb_products' layer, d = 64): the forward 4.976 ms a call (5.93 with the
// serial long pass), its items pass 4.966-4.969 ms and the tree 0.0143 ms
// in 3 launches (the serial pass 0.96 ms in 1); the backward 6.168 ms
// (7.12), the tree 0.018-0.019 ms. The items pass is the gathered rows:
// 15.8 GB, 4.73 ms at 3.35 TB/s; the forward reads them at 3.18 TB/s (the
// power-law sources' rows hit L2), the backward at 2.57 TB/s (each a
// random 256-byte read).
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; no function attribute to set.
#include <cuda_runtime.h>

namespace {

constexpr int SEG_WARPS = 8;  // items (or long rows) a block
constexpr unsigned SEG_FULL = 0xffffffffu;

template <int J>
__global__ void __launch_bounds__(32 * SEG_WARPS)
segsum_items_kernel(const float* __restrict__ h, const int* __restrict__ cols,
                    const float* __restrict__ w, const int4* __restrict__ items,
                    float* __restrict__ out, float* __restrict__ part,
                    long long n_items, int d) {
  const long long item = (long long)blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;  // the whole warp: item is uniform across it
  const int4 it = items[item];  // (row, first edge, end, partial slot or -1)
  const int c0 = blockIdx.y * 32 * J + lane;
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  for (int base = it.y; base < it.z; base += 32) {
    const int e = base + lane;
    int my_col = 0;
    float my_w = 0.f;
    if (e < it.z) {
      my_col = cols[e];
      my_w = w[e];
    }
    const int cnt = min(32, it.z - base);
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
      const int col = __shfl_sync(SEG_FULL, my_col, i);
      const float wi = __shfl_sync(SEG_FULL, my_w, i);
      const float* hr = h + (long long)col * d;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = c0 + 32 * j;
        if (c < d) acc[j] = __fadd_rn(acc[j], __fmul_rn(wi, __ldg(hr + c)));
      }
    }
  }
  float* dst = it.w < 0 ? out + (long long)it.x * d : part + (long long)it.w * d;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = c0 + 32 * j;
    if (c < d) dst[c] = acc[j];
  }
}

// One warp a group of one level of the long rows' tree: its count partial
// rows (slots first ..) added in slot order into a partial row (dst >= 0,
// a node of a later level) or output row -dst - 1. A level's groups read
// only rows that earlier launches wrote, and write rows no other group of
// the level touches.
__global__ void __launch_bounds__(32 * SEG_WARPS)
segsum_tree_kernel(float* part, const int4* __restrict__ groups,
                   float* __restrict__ out, long long n_groups, int d) {
  const long long gi = (long long)blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gi >= n_groups) return;
  const int4 g = groups[gi];  // (dst, first source, count, unused)
  const float* src = part + (long long)g.y * d;
  float* dst = g.x < 0 ? out + (long long)(-g.x - 1) * d : part + (long long)g.x * d;
  for (int c = lane; c < d; c += 32) {
    float acc = src[c];
    int s = 1;
    for (; s + 8 <= g.z; s += 8) {  // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = src[(long long)(s + i) * d + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, v[i]);
    }
    for (; s < g.z; ++s) acc = __fadd_rn(acc, src[(long long)s * d + c]);
    dst[c] = acc;
  }
}

template <int J>
void items_launch(const float* h, const int* cols, const float* w, const int4* items,
                  float* out, float* part, long long n_items, int d, cudaStream_t st) {
  const dim3 grid((unsigned)((n_items + SEG_WARPS - 1) / SEG_WARPS),
                  (unsigned)((d + 32 * J - 1) / (32 * J)));
  segsum_items_kernel<J><<<grid, 32 * SEG_WARPS, 0, st>>>(h, cols, w, items, out,
                                                          part, n_items, d);
}

}  // namespace

// The items pass: every work item's sum, into its output row (a row of
// one item) or its partial slot.
extern "C" int segsum_items_launch(const void* h, const void* cols,
                                   const void* w, const void* items, void* out,
                                   void* part, long long n_items, int d,
                                   void* stream) {
  if (d < 1 || n_items < 1 ||
      (n_items + SEG_WARPS - 1) / SEG_WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const int* ci = static_cast<const int*>(cols);
  const float* wf = static_cast<const float*>(w);
  const int4* it = static_cast<const int4*>(items);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  if (d <= 32)
    items_launch<1>(hf, ci, wf, it, o, p, n_items, d, st);
  else if (d <= 64)
    items_launch<2>(hf, ci, wf, it, o, p, n_items, d, st);
  else
    items_launch<4>(hf, ci, wf, it, o, p, n_items, d, st);
  return (int)cudaGetLastError();
}

// The long rows' pass, after the items pass: tree holds their groups,
// level i at [levels[i], levels[i + 1]) (a host array of n_levels + 1
// offsets); each level is one launch, in order.
extern "C" int segsum_tree_launch(void* part, const void* tree,
                                  const void* levels, void* out, int n_levels,
                                  int d, void* stream) {
  if (d < 1 || n_levels < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(levels);
  cudaError_t e = cudaSuccess;
  for (int l = 0; e == cudaSuccess && l < n_levels; ++l) {
    const long long n = lv[l + 1] - lv[l];
    segsum_tree_kernel<<<(unsigned)((n + SEG_WARPS - 1) / SEG_WARPS),
                         32 * SEG_WARPS, 0, st>>>(
        static_cast<float*>(part), static_cast<const int4*>(tree) + lv[l],
        static_cast<float*>(out), n, d);
    e = cudaGetLastError();
  }
  return (int)e;
}
