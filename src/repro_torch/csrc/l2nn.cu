// K3: nearest centroid (argmin, first index on ties) + true squared distance.
//
// Replaces the TPU kernel l2nn_kernel, launched by l2nn_pallas
// (src/repro/kernels/l2nn/kernel.py). Computes kernels/l2nn/ref.py, which
// is core/distance.nearest: argmin over c of ||c||^2 - 2 x.c, then that
// minimum + ||x||^2. The TPU kernel's augmented [-2x | 1].[c | ||c||^2]
// contraction is not copied: it can round differently from the plain form.
//
// Bound on the H100: at tree level 0 (C = 256 centroids, d = 128) each row
// costs 2 * 256 * 128 = 65,536 fp32 operations against 512 bytes read, so
// the kernel is bound by fp32 FMA throughput (67 TFLOP/s on the SXM part):
// 1.03 ms for 2^20 rows. Measured with chip_smoke.py on an H100 80GB HBM3
// (700 W limit): 3.87 ms, 27 % of that peak; shared-memory loads (two
// float4 per 16 FMAs) and the block barriers around each tile bound it.
//
// Design: one block per tile of 64 rows, staged once in shared memory;
// centroid tiles of 64 stream through shared memory, the same 4 x 4
// register-blocked fp32 FMA tile as K1/K2 forms the partial distances, and
// each row keeps a running (min, first argmin) in shared memory. No (N, C)
// matrix reaches device memory.
#include "common.cuh"

using namespace rt;

__global__ void __launch_bounds__(THREADS)
l2nn_kernel(const float* __restrict__ x, const float* __restrict__ cents,
            int* out_i, float* out_d, int N, int C, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float best_d[TQ];
  __shared__ int best_i[TQ];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* cs = xs + d * QPITCH;
  float* cn = cs + d * PPITCH;
  float* dt = cn + TP;
  const long long r0 = (long long)blockIdx.x * TQ;
  const int nr = min(TQ, N - (int)r0);
  stage_rows_t(xs, x, r0, nr, d, QPITCH, TQ);
  if (threadIdx.x < TQ) {
    best_d[threadIdx.x] = CUDART_INF_F;
    best_i[threadIdx.x] = -1;
  }
  for (int c0 = 0; c0 < C; c0 += TP) {
    const int nc = min(TP, C - c0);
    __syncthreads();
    stage_rows_t(cs, cents, c0, nc, d, PPITCH, TP);
    __syncthreads();
    if (threadIdx.x < TP) cn[threadIdx.x] = col_sq_norm(cs, threadIdx.x, d, PPITCH);
    float acc[4][4];
    tile_dots(xs, cs, d, acc);
    __syncthreads();
    write_tile(dt, cn, acc, [&](int, int p) { return p < nc; });
    __syncthreads();
    if (threadIdx.x < nr) {
      const int t = threadIdx.x;
      float bd = best_d[t];
      int bi = best_i[t];
      for (int p = 0; p < nc; ++p) {
        float v = dt[t * DPITCH + p];
        if (v < bd) {
          bd = v;
          bi = c0 + p;
        }
      }
      best_d[t] = bd;
      best_i[t] = bi;
    }
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int t = threadIdx.x;
    float xn = col_sq_norm(xs, t, d, QPITCH);
    out_i[r0 + t] = best_i[t];
    out_d[r0 + t] = __fadd_rn(best_d[t], xn);
  }
}

extern "C" int l2nn_launch(const void* x, const void* cents, void* out_i,
                           void* out_d, int N, int C, int d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  size_t smem = sizeof(float) * ((size_t)d * QPITCH + (size_t)d * PPITCH + TP +
                                 (size_t)TQ * DPITCH);
  cudaFuncSetAttribute(l2nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  l2nn_kernel<<<(N + TQ - 1) / TQ, THREADS, smem, st>>>(
      (const float*)x, (const float*)cents, (int*)out_i, (float*)out_d, N, C,
      d);
  return (int)cudaGetLastError();
}
