// K6, tensor-core variant: causal / sliding-window GQA flash attention on
// bf16 q, k, v with mma.sync (kernels/flashattn/ops.py picks it for bf16 at
// hd 64, 128 and 256; fp32 and smaller heads stay on flashattn.cu).
//
// Replaces the TPU kernel flashattn_kernel (src/repro/kernels/flashattn/
// kernel.py:34), launched by flashattn_pallas (:80). Computes
// kernels/flashattn/ref.py: for query row i of head h (KV head h / G) and key
// j, s = (q . k) * (1 / sqrt(hd)) in fp32 (a bf16 product is exact in fp32);
// s = -1e30 unless 0 <= (i + Skv - Sq) - j < window (no upper limit when
// window <= 0); an fp32 online softmax carries a running max m, denominator
// l and accumulator acc across key tiles; out = acc / max(l, 1e-30),
// rounded to bf16 once. Each row's log-sum-exp m + log(l) is written to
// lse too (fp32, (B, Hq, Sq)), for the backward.
//
// Bound on the H100: at the prefill shape of gemma3-4b's global layers
// (B = 4, S = 2048, 8 query heads over 4 KV heads, hd = 256) the causal half
// of the scores costs 68.7 GFLOP against 96 MiB of q, k, v and out, so the
// kernel is bound by the tensor cores: 0.07 ms at the bf16 peak
// (989 TFLOP/s, wgmma). mma.sync reaches a part of that rate; wgmma, TMA and
// warp specialisation are the next steps.
//
// Design: one block of 4 warps owns 64 flattened (position, head-in-group)
// query rows of one (batch, KV head), so the G query heads of a KV head
// share every staged K/V tile; each warp owns 16 rows. The q tile stays in
// shared memory; K/V tiles of 64 keys are double-buffered there by 16-byte
// cp.async copies, so tile t + 1 loads while tile t computes. Rows are
// padded by 16 bytes, which puts the 8 rows an ldmatrix reads in 8
// different bank groups. S = Q K^T and O += P V run as
// mma.m16n8k16 on bf16 with fp32 accumulators; fragments come from ldmatrix
// (.trans for V), and the score accumulators become the A operand of the PV
// product without leaving registers. m and l stay in fp32 registers (l as
// per-thread partial sums, reduced over the quad at the end).
//
// P enters the PV product as two bf16 terms, p = hi + lo with hi = bf16(p)
// and lo = bf16(p - hi), so each weight keeps 16 significant bits. Rounding
// p once to bf16 (as the plain version rounds its normalised weights) would
// round the weights a second time, independently of the plain version's
// rounding, and fp32_bound.attention_bf16_tol bounds only one such rounding:
// tests/test_torch_flashattn.py emulates both kernels on the CPU and shows
// the single rounding breaking that tolerance where the split holds it.
// The split costs a second PV mma on the same V fragments.
//
// Key tiles wholly above the diagonal or outside every row's window are
// skipped; the per-element mask runs only on tiles that straddle an edge. A
// row whose first tiles are wholly masked (m = -1e30, every p = 1) is wiped
// by alpha = exp(-1e30 - m) = 0 at its first unmasked tile, which the
// diagonal guarantees, as in the TPU kernel; keys past Skv and rows past
// Sq * G load as 0. q, k and v are read through their (B, S, H) strides:
// every row must be 16-byte aligned (the wrapper checks). expf and IEEE
// division (no fast math). The cp.async, ldmatrix, mma and split helpers
// live in tc_frag.cuh, shared with the backward (flashattn_bwd_tc.cu).
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; it sets its shared-memory size on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_frag.cuh"

namespace {

using namespace tc;

constexpr int R = 64;        // query rows per block
constexpr int TK = 64;       // keys per tile
constexpr int NWARP = 4;     // 16 query rows each
constexpr int NT = NWARP * 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int B, Sq, Skv, Hq, Hkv, G, window;
  float scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

template <int HD>
__global__ void __launch_bounds__(NT) flashattn_tc_kernel(Args a) {
  constexpr int P = HD + 8;   // shared row pitch in bf16: 16 bytes of padding
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr int ND = HD / 8;  // 8-wide output column tiles
  constexpr int NK = TK / 8;  // 8-key score tiles
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* qs = smem;              // [R][P]
  __nv_bfloat16* ks = qs + R * P;        // [2][TK][P]
  __nv_bfloat16* vs = ks + 2 * TK * P;   // [2][TK][P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.G, nrows = a.Sq * G, qoff = a.Skv - a.Sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * R;  // longest rows first
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const __nv_bfloat16* qb = a.q + b * a.qsb + (long long)kvh * G * a.qsh;
  const __nv_bfloat16* kb = a.k + b * a.ksb + kvh * a.ksh;
  const __nv_bfloat16* vb = a.v + b * a.vsb + kvh * a.vsh;

  for (int e = tid; e < R * CH; e += NT) {
    const int r = e / CH, c = e % CH, n = r0 + r;
    const bool ok = n < nrows;
    const __nv_bfloat16* src =
        ok ? qb + (long long)(n / G) * a.qss + (long long)(n % G) * a.qsh + c * 8 : qb;
    cp_async16(smem_addr(qs + r * P + c * 8), src, ok);
  }
  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* kd = ks + stage * TK * P;
    __nv_bfloat16* vd = vs + stage * TK * P;
    for (int e = tid; e < TK * CH; e += NT) {
      const int r = e / CH, c = e % CH, j = t * TK + r;
      const bool ok = j < a.Skv;
      cp_async16(smem_addr(kd + r * P + c * 8),
                 ok ? kb + (long long)j * a.kss + c * 8 : kb, ok);
      cp_async16(smem_addr(vd + r * P + c * 8),
                 ok ? vb + (long long)j * a.vss + c * 8 : vb, ok);
    }
  };

  // keys any row of the block may see: tiles [t_lo, t_hi]
  const int n_last = min(r0 + R, nrows) - 1;
  const int qmin = r0 / G + qoff, qmax = n_last / G + qoff;
  const int t_lo = (a.window > 0 ? max(0, qmin - a.window + 1) : 0) / TK;
  const int t_hi = qmax / TK;
  load_kv(t_lo, 0);
  cp_async_commit();

  const int wr = warp * 16;  // this warp's first row in the block
  int qa[2];                 // absolute positions of rows g and g + 8
  qa[0] = (r0 + wr + g) / G + qoff;
  qa[1] = (r0 + wr + g + 8) / G + qoff;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t < t_hi) load_kv(t + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: one group per step
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * TK * P;
    const __nv_bfloat16* vst = vs + stage * TK * P;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qf[4];
      ldsm_x4(smem_addr(qs + (wr + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8), qf);
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t kf[4];
        ldsm_x4(smem_addr(kst + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                          kk * 16 + ((lane >> 3) & 1) * 8),
                kf);
        mma_bf16(s[2 * n2], qf, kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf, kf[2], kf[3]);
      }
    }

    // scale, mask (edge tiles only), online softmax
    const int j0 = t * TK;
    const bool edge = !(j0 + TK - 1 <= qmin && j0 + TK <= a.Skv &&
                        (a.window <= 0 || qmax - j0 < a.window));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if (edge) {
          const int j = j0 + n * 8 + 2 * t4 + (e & 1), dist = qa[e >> 1] - j;
          const bool ok = dist >= 0 && j < a.Skv && (a.window <= 0 || dist < a.window);
          x = ok ? x : -1e30f;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: the score tiles are the A fragments, hi then lo
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t vf[4];
        ldsm_x4_t(smem_addr(vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                            d2 * 16 + (lane >> 4) * 8),
                  vf);
        mma_bf16(acc[2 * d2], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * d2], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * d2 + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * d2 + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = r0 + wr + g + 8 * i;
    if (n >= nrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        a.o + (((long long)b * a.Sq + n / G) * a.Hq + kvh * G + n % G) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[d][2 * i] / den, acc[d][2 * i + 1] / den);
    if (t4 == 0)
      a.lse[((long long)b * a.Hq + kvh * G + n % G) * a.Sq + n / G] =
          m[i] + logf(l[i]);
  }
}

template <int HD>
int launch_t(const Args& a, cudaStream_t st) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(R + 4 * TK) * (HD + 8);
  cudaError_t e = cudaFuncSetAttribute(
      flashattn_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.B * a.Hkv),
                  (unsigned)((a.Sq * (long long)a.G + R - 1) / R));
  flashattn_tc_kernel<HD><<<grid, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; strides are in elements, for dims (B, S, H), each a multiple
// of 8 (16-byte rows); the head dimension is dense. out is a dense
// (B, Sq, Hq, hd) tensor, lse a dense fp32 (B, Hq, Sq) one.
extern "C" int flashattn_tc_launch(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int hd, int window, float scale,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   void* stream) {
  const long long strides[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (B < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sq > Skv ||
      (long long)B * Hkv > (1LL << 31) - 1 ||
      ((long long)Sq * (Hq / Hkv) + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
         B, Sq, Skv, Hq, Hkv, Hq / Hkv, window, scale,
         qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_t<64>(a, st);
    case 128: return launch_t<128>(a, st);
    case 256: return launch_t<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
