// K6: fused causal / sliding-window GQA attention (flash dataflow).
//
// Replaces the TPU kernel flashattn_kernel (src/repro/kernels/flashattn/
// kernel.py:34), launched by flashattn_pallas (:80). Computes
// kernels/flashattn/ref.py: for query row i of head h (KV head h / G, G =
// Hq / Hkv) and key j, s = (q . k) * (1 / sqrt(hd)) in fp32; s = -1e30
// unless 0 <= (i + Skv - Sq) - j < window (no upper limit when window <= 0);
// an online softmax carries a running max m, denominator l and accumulator
// acc in fp32 across key tiles; out = acc / max(l, 1e-30), cast to the
// input type. Each row's log-sum-exp m + log(l) is written to lse too
// (fp32, (B, Hq, Sq)): the backward (flashattn_bwd.cu) reads it. Inputs are fp32 or bf16 (converted exactly to fp32 on load),
// in the reference's (B, S, H, hd) layout read through strides: no
// transposed copy is made.
//
// Bound on the H100: at the prefill shape of gemma3-4b's global layers
// (B = 4, S = 2048, 8 query heads over 4 KV heads, hd = 256) the causal
// half of the scores costs about 68.7 GFLOP against 96 MiB of q, k, v and
// out, so the kernel is bound by arithmetic: 0.07 ms at the bf16 tensor-
// core peak (989 TFLOP/s), 1.03 ms at the fp32 FMA peak (67 TFLOP/s).
// This first version runs fp32 FMAs on the CUDA cores, so the fp32 peak is
// its own ceiling; the tensor cores (mma / wgmma on bf16 tiles) are the
// next step, within the fp32-accumulation contract.
//
// Design: one block of 256 threads owns 64 query rows of one (batch, KV
// head): the rows are the flattened (position, head-in-group) pairs, so
// the G query heads that share a KV head share every staged KV tile (the
// TPU kernel streams each KV tile once per query head). The block loops
// over 64-key tiles itself (the TPU carries m, l, acc across a sequential
// grid axis in VMEM; CUDA blocks run in no order): q (transposed), k
// (transposed), v and the probability tile live in shared memory (223 KB
// at hd = 256, dynamic), each thread keeps a 4 x 4 score tile and a 4-row
// slice of the accumulator in registers. Key tiles wholly above the causal
// diagonal or wholly outside every row's window are skipped: they add
// exactly 0. A row whose first tiles are wholly masked (m = -1e30, every
// p = 1) is wiped by alpha = exp(-1e30 - m) = 0 at its first unmasked
// tile, which the diagonal guarantees, exactly as in the TPU kernel; keys
// past Skv load as 0, so nothing non-finite enters. expf and IEEE division
// (no fast math).
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; it sets its shared-memory size on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int R = 64;        // query rows per block
constexpr int TK = 64;       // keys per tile
constexpr int NT = 256;      // 16 x 16 threads
constexpr int QP = R + 4;    // pitch of the transposed q and p tiles
constexpr int KP = TK + 4;   // pitch of the transposed k tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Skv, Hq, Hkv, G, window;
  float scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flashattn_kernel(Args a) {
  constexpr int CG = HD / 4 < 16 ? HD / 4 : 16;  // float4 column groups (PV)
  constexpr int NV = HD / 4 / CG;                // float4s per thread per row
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [HD][QP]: qt[d * QP + r]
  float* kt = qt + HD * QP;      // [HD][KP]: kt[d * KP + c]
  float* vs = kt + HD * KP;      // [TK][HD]
  float* pt = vs + TK * HD;      // [TK][QP]: pt[c * QP + r]
  float* m_s = pt + TK * QP;     // [R] running max
  float* l_s = m_s + R;          // [R] running denominator
  float* a_s = l_s + R;          // [R] this tile's rescale factor

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = a.G, nrows = a.Sq * G, qoff = a.Skv - a.Sq;
  const int r0 = blockIdx.x * R;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const long long qb = b * a.qsb + (long long)kvh * G * a.qsh;
  const long long kb = b * a.ksb + kvh * a.ksh;
  const long long vb = b * a.vsb + kvh * a.vsh;

  // q tile, transposed; lanes take 4 rows x 8 dims (conflict-free stores)
  for (int e = tid; e < R * HD; e += NT) {
    const int r = (e & 3) + 4 * (e / (4 * HD)), d = (e >> 2) % HD;
    const int n = r0 + r;
    float x = 0.f;
    if (n < nrows)
      x = ld(q + qb + (long long)(n / G) * a.qss + (long long)(n % G) * a.qsh + d);
    qt[d * QP + r] = x;
  }
  if (tid < R) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][NV * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int x = 0; x < NV * 4; ++x) acc[i][x] = 0.f;
  int qa[4];  // absolute position of each of this thread's score rows
#pragma unroll
  for (int i = 0; i < 4; ++i) qa[i] = (r0 + ty * 4 + i) / G + qoff;

  // keys any row of the block may see: [j_lo, j_hi]
  const int n_last = min(r0 + R, nrows) - 1;
  const int j_hi = n_last / G + qoff;
  const int j_lo = a.window > 0 ? max(0, r0 / G + qoff - a.window + 1) : 0;

  for (int t = j_lo / TK; t <= j_hi / TK; ++t) {
    const int j0 = t * TK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < TK * HD; e += NT) {
      const int c = (e & 3) + 4 * (e / (4 * HD)), d = (e >> 2) % HD;
      const int j = j0 + c;
      kt[d * KP + c] = j < a.Skv ? ld(k + kb + (long long)j * a.kss + d) : 0.f;
    }
    for (int e = tid; e < TK * HD; e += NT) {
      const int c = e / HD, d = e % HD;
      const int j = j0 + c;
      vs[c * HD + d] = j < a.Skv ? ld(v + vb + (long long)j * a.vss + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[d * QP + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&kt[d * KP + tx * 4]);
      const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
    }

    // scale, mask, online softmax; the 16 lanes of a half-warp share rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = j0 + tx * 4 + j, dist = qa[i] - kj;
        const bool ok = dist >= 0 && kj < a.Skv && (a.window <= 0 || dist < a.window);
        s[i][j] = ok ? s[i][j] * a.scale : -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (tx == 0) {  // every lane has read m_old: the shuffles above wait for them
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * QP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    if (tx < CG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = a_s[ty * 4 + i];
#pragma unroll
        for (int x = 0; x < NV * 4; ++x) acc[i][x] *= al;
      }
#pragma unroll 4
      for (int c = 0; c < TK; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(&pt[c * QP + ty * 4]);
        const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[c * HD + (tx + CG * u) * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][u * 4 + 0] = fmaf(pp[i], vv.x, acc[i][u * 4 + 0]);
            acc[i][u * 4 + 1] = fmaf(pp[i], vv.y, acc[i][u * 4 + 1]);
            acc[i][u * 4 + 2] = fmaf(pp[i], vv.z, acc[i][u * 4 + 2]);
            acc[i][u * 4 + 3] = fmaf(pp[i], vv.w, acc[i][u * 4 + 3]);
          }
        }
      }
    }
  }

  if (tx < CG) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, n = r0 + r;
      if (n >= nrows) continue;
      const float den = fmaxf(l_s[r], 1e-30f);
      T* orow = o + (((long long)b * a.Sq + n / G) * a.Hq + kvh * G + n % G) * HD;
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          put(orow + (tx + CG * u) * 4 + x, acc[i][u * 4 + x] / den);
      if (tx == 0)
        a.lse[((long long)b * a.Hq + kvh * G + n % G) * a.Sq + n / G] =
            m_s[r] + logf(l_s[r]);
    }
  }
}

template <typename T, int HD>
int launch_t(const Args& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)HD * QP + (size_t)HD * KP +
                                       (size_t)TK * HD + (size_t)TK * QP + 3 * R);
  cudaError_t e = cudaFuncSetAttribute(
      flashattn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.Sq * (long long)a.G + R - 1) / R),
                  (unsigned)(a.B * a.Hkv));
  flashattn_kernel<T, HD><<<grid, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 8: return launch_t<T, 8>(a, st);
    case 16: return launch_t<T, 16>(a, st);
    case 32: return launch_t<T, 32>(a, st);
    case 64: return launch_t<T, 64>(a, st);
    case 128: return launch_t<T, 128>(a, st);
    case 256: return launch_t<T, 256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Strides are in elements, for dims (B, S, H);
// the head dimension is dense. out is a dense (B, Sq, Hq, hd) tensor, lse
// a dense fp32 (B, Hq, Sq) one.
extern "C" int flashattn_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int Sq, int Skv, int Hq,
                                int Hkv, int hd, int window, int dtype,
                                float scale, long long qsb, long long qss,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long vsb, long long vss,
                                long long vsh, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sq > Skv ||
      (long long)B * Hkv > 65535 || (long long)Sq * (Hq / Hkv) > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, Hq / Hkv, window, scale,
         qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, hd, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, hd, st);
  return (int)cudaErrorInvalidValue;
}
