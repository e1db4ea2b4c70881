// K3: nearest centroid (argmin, first index on ties) + true squared distance.
//
// Replaces the TPU kernel l2nn_kernel, launched by l2nn_pallas
// (src/repro/kernels/l2nn/kernel.py). Computes kernels/l2nn/ref.py, which
// is core/distance.nearest: argmin over c of ||c||^2 - 2 x.c, then that
// minimum + ||x||^2. The TPU kernel's augmented [-2x | 1].[c | ||c||^2]
// contraction is not copied: it can round differently from the plain form.
//
// Bound on the H100: each row costs 2 * C * d fp32 operations against 4 d
// bytes read, so the kernel is bound by fp32 FMA throughput (67 TFLOP/s on
// the SXM part): 1.03 ms at tree level 0 (2^20 rows, C = 256, d = 128), 4.0
// us for one of build_index's 4,096-row waves against the same centroids.
// Measured with scripts/dense_kernels_ab.py on an H100 80GB HBM3 (700 W
// limit): 2.381 ms at tree level 0 (43 % of that peak; the earlier
// 64-row tile kernel 3.86 ms) and 0.0152 ms a build wave (0.0481 ms).
// TF32 and wgmma stay out: the exactness contract (common.cuh) is fp32.
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; its shared-memory opt-in is set once per device.

//
// Design: one block of 8 warps takes 32 rows and every centroid. Its x tile
// is staged once (cp.async) with a row pitch of 4 (mod 8) floats; the
// centroids stream through a double-buffered shared chunk of 256 rows x 32
// columns of d (cp.async, 16-byte copies, row pitch 36), so 4,096 rows make
// 128 blocks on 132 SMs and 2^20 rows run two blocks an SM. Warp (rw, ch)
// computes rows rw * 8 .. + 7 against centroids ch * 128 + lane + 32 j
// (j = 0..3): each step of 4 columns reads 4 float4 of centroids (lane
// stride 36: no bank conflict), 8 broadcast float4 of x, and issues 128
// FMAs, 8 x 4 outputs a thread in registers. Every ||c||^2 and ||x||^2 is
// computed once, in the same loop, by one lane's fmaf chain over c =
// 0..d-1, as every x.c is: bit for bit the plain version's sums on
// integer data, and one rounding of ||c||^2 - 2 x.c (__fsub_rn). Each
// thread keeps its rows' (min, first argmin) over its centroids in
// registers (centroids ascend, so a later equal value never wins); shuffles
// fold the 32 lanes and shared memory the two halves, by (value, index).
// No (N, C) matrix and no distance tile exist.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int NN_RG = 4;            // warps along rows
constexpr int NN_RM = 8;            // rows a warp
constexpr int NN_TR = NN_RG * NN_RM;  // rows a block
constexpr int NN_CB = 256;          // centroids a block step (2 x 128)
constexpr int NN_DK = 32;           // columns of d a staged chunk
constexpr int NN_CP = NN_DK + 4;    // chunk row pitch: 36 = 4 (mod 32)

__host__ __device__ inline int nn_dpad(int d) { return (d + 3) / 4 * 4; }
// x tile row pitch, 4 (mod 8): lanes reading 8 rows' float4 do not conflict
__host__ __device__ inline int nn_xpitch(int d) { return (d + 7) / 8 * 8 + 4; }

inline size_t nn_smem_bytes(int d) {
  return sizeof(float) * ((size_t)NN_TR * nn_xpitch(d) + 2 * NN_CB * NN_CP +
                          NN_CB + 3 * NN_TR) +
         sizeof(int) * 2 * NN_TR;
}

__device__ __forceinline__ bool nn_less(float v, int i, float v2, int i2) {
  return v < v2 || (v == v2 && i < i2);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
l2nn_kernel(const float* __restrict__ x, const float* __restrict__ cents,
            int* out_i, float* out_d, int N, int C, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % NN_RG, ch = warp / NN_RG;
  const int XP = nn_xpitch(d), dp = nn_dpad(d);
  float* xs = reinterpret_cast<float*>(smem_raw);  // [NN_TR][XP]
  float* cs = xs + NN_TR * XP;                     // [2][NN_CB][NN_CP]
  float* cn = cs + 2 * NN_CB * NN_CP;              // [NN_CB] this step's norms
  float* ex_v = cn + NN_CB;                        // [2][NN_TR] halves' minima
  float* xn_s = ex_v + 2 * NN_TR;                  // [NN_TR]
  int* ex_i = reinterpret_cast<int*>(xn_s + NN_TR);  // [2][NN_TR]
  const long long r0 = (long long)blockIdx.x * NN_TR;
  const int n_kc = (d + NN_DK - 1) / NN_DK;
  const int n_steps = n_kc * ((C + NN_CB - 1) / NN_CB);

  // the x tile, columns d..dp-1 zero (they add exact zeros below)
  if (VEC) {
    const int q4 = dp / 4;
    for (int f = threadIdx.x; f < NN_TR * q4; f += THREADS) {
      const int r = f / q4, c = (f - r * q4) * 4;
      const bool ok = r0 + r < N;
      cp_async16(xs + r * XP + c, ok ? x + (r0 + r) * d + c : x, ok);
    }
  } else {
    for (int f = threadIdx.x; f < NN_TR * dp; f += THREADS) {
      const int r = f / dp, c = f - r * dp;
      const bool ok = r0 + r < N && c < d;
      cp_async4(xs + r * XP + c, ok ? x + (r0 + r) * d + c : x, ok);
    }
  }
  // step s: centroids (s / n_kc) * 256 .., columns (s % n_kc) * 32 ..
  auto stage = [&](int s) {
    const int c0 = (s / n_kc) * NN_CB, k0 = (s % n_kc) * NN_DK;
    float* buf = cs + (s & 1) * NN_CB * NN_CP;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < NN_CB * NN_DK / 4 / THREADS; ++i) {
        const int f = threadIdx.x + THREADS * i, r = f >> 3, c = (f & 7) * 4;
        const bool ok = c0 + r < C && k0 + c < d;
        cp_async16(buf + r * NN_CP + c,
                   ok ? cents + (size_t)(c0 + r) * d + k0 + c : cents, ok);
      }
    } else {
      for (int i = 0; i < NN_CB * NN_DK / THREADS; ++i) {
        const int f = threadIdx.x + THREADS * i, r = f >> 5, c = f & 31;
        const bool ok = c0 + r < C && k0 + c < d;
        cp_async4(buf + r * NN_CP + c,
                  ok ? cents + (size_t)(c0 + r) * d + k0 + c : cents, ok);
      }
    }
  };
  stage(0);
  cp_async_commit();  // the x tile and step 0

  float acc[NN_RM][4], bv[NN_RM];
  int bi[NN_RM];
#pragma unroll
  for (int i = 0; i < NN_RM; ++i) {
    bv[i] = CUDART_INF_F;
    bi[i] = INT32_MAX;
  }
  float cnacc = 0.f, xnacc = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) stage(s + 1);
    cp_async_commit();  // possibly empty: one group a step
    cp_async_wait<1>();
    __syncthreads();  // step s (and the x tile) landed for every thread
    const int cb = s / n_kc, kc = s % n_kc, k0 = kc * NN_DK;
    const int kw = min(NN_DK, dp - k0);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < NN_RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      cnacc = 0.f;
    }
    const float* crow = cs + (s & 1) * NN_CB * NN_CP + (ch * 128 + lane) * NN_CP;
    const float* xrow = xs + rw * NN_RM * XP + k0;
    const float* xmine = xs + (rw * NN_RM + lane % NN_RM) * XP + k0;
#pragma unroll
    for (int c4 = 0; c4 < NN_DK; c4 += 4) {
      if (c4 >= kw) break;  // block-uniform
      float4 cv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cv[j] = *reinterpret_cast<const float4*>(crow + j * 32 * NN_CP + c4);
#pragma unroll
      for (int i = 0; i < NN_RM; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xrow + i * XP + c4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv.x, cv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv.y, cv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv.z, cv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv.w, cv[j].w, acc[i][j]);
        }
      }
      // ||c||^2 of centroid ch * 128 + rw * 32 + lane: this lane's j == rw
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j == rw) {
          cnacc = fmaf(cv[j].x, cv[j].x, cnacc);
          cnacc = fmaf(cv[j].y, cv[j].y, cnacc);
          cnacc = fmaf(cv[j].z, cv[j].z, cnacc);
          cnacc = fmaf(cv[j].w, cv[j].w, cnacc);
        }
      // ||x||^2 of row rw * 8 + lane % 8, once (first centroid step)
      if (ch == 0 && cb == 0) {
        const float4 xo = *reinterpret_cast<const float4*>(xmine + c4);
        xnacc = fmaf(xo.x, xo.x, xnacc);
        xnacc = fmaf(xo.y, xo.y, xnacc);
        xnacc = fmaf(xo.z, xo.z, xnacc);
        xnacc = fmaf(xo.w, xo.w, xnacc);
      }
    }
    if (kc == n_kc - 1) {  // block-uniform: these 256 centroids are done
      cn[ch * 128 + rw * 32 + lane] = cnacc;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cb * NN_CB + ch * 128 + j * 32 + lane;
        const float cnj = cn[ch * 128 + j * 32 + lane];
#pragma unroll
        for (int i = 0; i < NN_RM; ++i) {
          const float v = __fsub_rn(cnj, 2.0f * acc[i][j]);
          if (col < C && nn_less(v, col, bv[i], bi[i])) {
            bv[i] = v;
            bi[i] = col;
          }
        }
      }
    }
    __syncthreads();  // buffer s & 1 and cn are free again
  }
  cp_async_wait<0>();

  // fold the 32 lanes, then the two halves, by (value, index)
#pragma unroll
  for (int i = 0; i < NN_RM; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv[i], off);
      const int oi = __shfl_xor_sync(FULL, bi[i], off);
      if (nn_less(ov, oi, bv[i], bi[i])) {
        bv[i] = ov;
        bi[i] = oi;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NN_RM; ++i) {
      ex_v[ch * NN_TR + rw * NN_RM + i] = bv[i];
      ex_i[ch * NN_TR + rw * NN_RM + i] = bi[i];
    }
  }
  if (ch == 0 && lane < NN_RM) xn_s[rw * NN_RM + lane] = xnacc;
  __syncthreads();
  if (threadIdx.x < NN_TR && r0 + threadIdx.x < N) {
    const int r = threadIdx.x;
    float v = ex_v[r];
    int i = ex_i[r];
    if (nn_less(ex_v[NN_TR + r], ex_i[NN_TR + r], v, i)) {
      v = ex_v[NN_TR + r];
      i = ex_i[NN_TR + r];
    }
    out_i[r0 + r] = i;
    out_d[r0 + r] = __fadd_rn(v, xn_s[r]);
  }
}

template <bool VEC>
int nn_launch(const float* x, const float* cents, int* out_i, float* out_d,
              int N, int C, int d, cudaStream_t st) {
  // once per instantiation and device, at the largest size
  static bool attr_set[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        l2nn_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)nn_smem_bytes(MAX_D));
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  l2nn_kernel<VEC><<<(N + NN_TR - 1) / NN_TR, THREADS, nn_smem_bytes(d), st>>>(
      x, cents, out_i, out_d, N, C, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int l2nn_launch(const void* x, const void* cents, void* out_i,
                           void* out_d, int N, int C, int d, void* stream) {
  if (N < 1 || C < 1 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte copies need 16-byte aligned rows
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cents) % 16 == 0;
  return vec ? nn_launch<true>((const float*)x, (const float*)cents,
                               (int*)out_i, (float*)out_d, N, C, d, st)
             : nn_launch<false>((const float*)x, (const float*)cents,
                                (int*)out_i, (float*)out_d, N, C, d, st);
}
