// K6 backward, tensor-core variant: the gradient of causal / sliding-window
// GQA flash attention on bf16 q, k, v with mma.sync (kernels/flashattn/
// ops.py picks it for bf16 at hd 64, 128 and 256, as it picks the forward's
// flashattn_tc.cu; fp32 and smaller heads stay on flashattn_bwd.cu).
//
// Replaces no TPU kernel: the JAX package's Pallas K6 (src/repro/kernels/
// flashattn/kernel.py:80) has no VJP, and its training differentiates the
// XLA attention. It computes kernels/flashattn/ref.py flash_attention_bwd_ref
// from q, k, v, the forward's out and per-row log-sum-exp lse (fp32,
// (B, Hq, Sq)) and the output's gradient dout, with the forward's scores
// s = (q . k) * scale and mask (-1e30 unless 0 <= (i + Skv - Sq) - j <
// window, no upper limit when window <= 0):
//
//   P = exp(s - lse)   D = rowsum(dout * out)   dS = P * (dout V^T - D)
//   dq = scale dS K    dk = scale sum_g dS^T Q   dv = sum_g P^T dout
//
// in fp32 sums, each gradient rounded to bf16 once. expf, no fast math.
//
// Bound on the H100: at the training step's shape (B 2, S 4096, 16 query
// heads over 8 KV heads, hd 128, causal) the five products cost 2 * 5 * hd
// flops a (query, key) pair, 344 GFLOP: 0.35 ms at the bf16 tensor-core
// peak (989 TFLOP/s, wgmma); the bytes (q, k, v, out, dout, the three
// gradients, lse) take 0.03 ms. Bound by the tensor cores. mma.sync
// reaches a part of that rate; wgmma, TMA and warp specialisation are the
// next steps.
//
// Design. Deterministic: no floating-point atomics; every output element is
// summed by one thread in one order. Three launches:
//  * bwd_tc_d_kernel: D, one warp a (batch, position, head) row.
//  * bwd_tc_dkdv_kernel: one block of 4 warps owns BC = 64 keys of one
//    (batch, KV head), 16 a warp, and walks the flattened (position,
//    head-in-group) query rows that can see them, BR = 32 a step, so dk and
//    dv sum over the group inside the block. Keys are the M dimension: the
//    warp computes S^T = K Q^T and dP^T = V dout^T (16 keys x 32 rows), so
//    P^T and dS^T leave the accumulators already in the A-operand layout
//    of dV += P^T dout and dK += dS^T Q; Q and dout enter those as B
//    operands through ldmatrix.trans, with no trip through shared memory.
//    lse and D are per query row, a column of the transposed tiles. The
//    K and V tiles stay in shared memory; the row tiles (q, dout, lse, D)
//    are double-buffered by cp.async, so step t + 1 loads while t computes.
//  * bwd_tc_dq_kernel: one block of 4 warps owns 64 query rows (16 a warp;
//    lse and D of its two rows a thread in registers) and walks the key
//    tiles they can see, double-buffered: S = Q K^T, dP = dout V^T, then
//    dQ += dS K with dS the A operand straight from the accumulators and K
//    read through ldmatrix.trans.
// S and dP are recomputed in both passes (seven products where five are
// the work) to stay free of atomics. All products are mma.m16n8k16 on bf16
// with fp32 accumulators (tc_frag.cuh, shared with the forward).
//
// P and dS enter their products as two bf16 terms, hi = bf16(x) and lo =
// bf16(x - hi), as the forward's P does: fp32_bound.attention_grads_f64's
// bf16 tolerance bounds an fp32 evaluation whose gradients are rounded to
// bf16 once, and a second, independent rounding of P (2^-9 relative on
// each term of a key's sum over thousands of rows) leaves it wherever dv's
// sum cancels; a single rounding of dS leaves it for dk on the CPU
// emulation in tests/test_torch_flashattn.py, which shows both. The split
// costs three more products (ten mma products in all for the five of the
// work).
//
// Tiles, registers. Rows of shared tiles are padded by 16 bytes, which puts
// the 8 rows an ldmatrix reads in 8 different bank groups. At hd 128 a
// dk/dv thread holds 64 + 64 accumulators of dK and dV and 16 + 16 of S^T
// and dP^T; BR = 32 (not 64) keeps that under the 255-register limit
// without spills. `nvcc -Xptxas -v` (logged by chip_smoke.py at every
// build) on the H100's toolkit: dk/dv 133 / 242 / 242 registers at hd 64 /
// 128 / 256, dq 160 / 238 / 168, D 24, no spills; two blocks an SM at hd
// 128 (68.5 and 102 KiB of shared memory). At hd 256 the dK and dV
// accumulators of 16 keys would take 256 registers, so both passes split
// the gradients' columns across two blocks (blockIdx.z): each recomputes S
// and dP over all 256 columns and sums its 128 columns of dK and dV, or of
// dQ (the dq pass's 128 accumulators of a whole row left `ptxas` 255
// registers and spills); its dq pass takes key tiles of 16, so that two
// blocks fit an SM. Tiles wholly outside the causal diagonal or the window
// are skipped, and the per-element mask runs only on steps that straddle
// an edge. Heavy tiles start first: low key tiles in the dk/dv pass, late
// query tiles in the dq pass.
//
// q, k and v are read through their (B, S, H) strides; every row must be
// 16-byte aligned (the wrapper checks). out, dout and dq are dense (B, Sq,
// Hq, hd), dk and dv dense (B, Skv, Hkv, hd).
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; it sets its shared-memory sizes on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_frag.cuh"

namespace {

using namespace tc;

constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;
constexpr int BC = 64;  // keys a dk/dv block, 16 a warp
constexpr int BR = 32;  // query rows a step of the dk/dv pass
constexpr int RQ = 64;  // query rows a dq block, 16 a warp
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;     // dense (B, Sq, Hq, hd)
  const float* lse;           // dense (B, Hq, Sq)
  const __nv_bfloat16* dout;  // dense (B, Sq, Hq, hd)
  __nv_bfloat16* dq;          // dense (B, Sq, Hq, hd)
  __nv_bfloat16* dk;          // dense (B, Skv, Hkv, hd)
  __nv_bfloat16* dv;
  float* D;  // scratch, dense (B, Hq, Sq)
  int B, Sq, Skv, Hq, Hkv, G, window;
  float scale;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// Gradient columns a block sums: 128 at hd 256 (two blocks a tile).
template <int HD>
__host__ __device__ constexpr int grad_cols() { return HD > 128 ? 128 : HD; }

// Keys a dq step takes: 16 at hd 256, whose q and dout tiles are twice as
// wide (two blocks an SM fit in shared memory).
template <int HD>
__host__ __device__ constexpr int dq_tile() { return HD > 128 ? 16 : 64; }

// D[b, h, i] = sum_d dout * out in fp32, one warp a row of the dense
// (B, Sq, Hq) order.
template <int HD>
__global__ void __launch_bounds__(NT) bwd_tc_d_kernel(Args a) {
  const long long row = (long long)blockIdx.x * NWARP + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Sq * a.Hq) return;
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(a.o + row * HD);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(a.dout + row * HD);
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < HD / 2; d += 32) {
    const float2 x = __bfloat1622float2(g[d]), y = __bfloat1622float2(o[d]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) s += __shfl_xor_sync(FULL, s, w);
  if (lane == 0) {
    const int h = (int)(row % a.Hq);
    const long long bp = row / a.Hq;
    a.D[((bp / a.Sq) * a.Hq + h) * a.Sq + bp % a.Sq] = s;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) bwd_tc_dkdv_kernel(Args a) {
  constexpr int P = HD + 8;   // shared row pitch in bf16: 16 bytes of padding
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr int NR = BR / 8;  // 8-row score tiles a step
  constexpr int DH = grad_cols<HD>();
  constexpr int ND = DH / 8;  // 8-wide dK / dV column tiles
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* ks = smem;               // [BC][P]
  __nv_bfloat16* vs = ks + BC * P;        // [BC][P]
  __nv_bfloat16* qs = vs + BC * P;        // [2][BR][P]
  __nv_bfloat16* gs = qs + 2 * BR * P;    // [2][BR][P]: dout
  float* lse_s = reinterpret_cast<float*>(gs + 2 * BR * P);  // [2][BR]
  float* d_s = lse_s + 2 * BR;                               // [2][BR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.G, nrows = a.Sq * G, qoff = a.Skv - a.Sq;
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int j0 = blockIdx.y * BC;  // low key tiles (the most rows) first
  const int c0 = blockIdx.z * DH;  // this block's columns of dK and dV
  const __nv_bfloat16* qb = a.q + b * a.qsb + (long long)kvh * G * a.qsh;
  const __nv_bfloat16* kb = a.k + b * a.ksb + kvh * a.ksh;
  const __nv_bfloat16* vb = a.v + b * a.vsb + kvh * a.vsh;

  // query rows that see a key of the tile: positions in [j0, j0 + BC - 2 +
  // window] (no upper limit without a window)
  const int n_lo = max(0, j0 - qoff) * G;
  const int n_hi = a.window > 0
                       ? (int)min((long long)nrows,
                                  max(0LL, ((long long)j0 + BC - 1 + a.window - qoff) * G))
                       : nrows;

  auto load_rows = [&](int n0, int stage) {
    __nv_bfloat16* qd = qs + stage * BR * P;
    __nv_bfloat16* gd = gs + stage * BR * P;
    for (int e = tid; e < BR * CH; e += NT) {
      const int r = e / CH, c = e % CH, n = n0 + r;
      const bool ok = n < n_hi;
      const long long pos = n / G, hg = n % G;
      cp_async16(smem_addr(qd + r * P + c * 8),
                 ok ? qb + pos * a.qss + hg * a.qsh + c * 8 : qb, ok);
      cp_async16(smem_addr(gd + r * P + c * 8),
                 ok ? a.dout + (((long long)b * a.Sq + pos) * a.Hq + kvh * G + hg) * HD + c * 8
                    : a.dout,
                 ok);
    }
    for (int r = tid; r < BR; r += NT) {
      const int n = n0 + r;
      const bool ok = n < n_hi;
      const long long at = ok ? ((long long)b * a.Hq + kvh * G + n % G) * a.Sq + n / G : 0;
      cp_async4(smem_addr(lse_s + stage * BR + r), a.lse + at, ok);
      cp_async4(smem_addr(d_s + stage * BR + r), a.D + at, ok);
    }
  };

  if (n_lo < n_hi) {
    for (int e = tid; e < BC * CH; e += NT) {
      const int r = e / CH, c = e % CH, j = j0 + r;
      const bool ok = j < a.Skv;
      cp_async16(smem_addr(ks + r * P + c * 8), ok ? kb + (long long)j * a.kss + c * 8 : kb,
                 ok);
      cp_async16(smem_addr(vs + r * P + c * 8), ok ? vb + (long long)j * a.vss + c * 8 : vb,
                 ok);
    }
    load_rows(n_lo, 0);
  }
  cp_async_commit();

  const int kr = warp * 16;  // this warp's first key in the tile
  int ja[2];                 // keys of rows g and g + 8 of its tiles
  ja[0] = j0 + kr + g;
  ja[1] = j0 + kr + g + 8;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int n0 = n_lo, it = 0; n0 < n_hi; n0 += BR, ++it) {
    const int stage = it & 1;
    if (n0 + BR < n_hi) load_rows(n0 + BR, stage ^ 1);
    cp_async_commit();  // possibly empty: one group per step
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* qst = qs + stage * BR * P;
    const __nv_bfloat16* gst = gs + stage * BR * P;
    const float* lst = lse_s + stage * BR;
    const float* dst = d_s + stage * BR;

    // S^T = K Q^T and dP^T = V dout^T for the warp's 16 keys x BR rows
    float st[NR][4], dpt[NR][4];
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[4], vf[4];
      const int a_off = (kr + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_addr(ks + a_off), kf);
      ldsm_x4(smem_addr(vs + a_off), vf);
#pragma unroll
      for (int n2 = 0; n2 < NR / 2; ++n2) {
        uint32_t qf[4], gf[4];
        const int b_off = (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(qst + b_off), qf);
        ldsm_x4(smem_addr(gst + b_off), gf);
        mma_bf16(st[2 * n2], kf, qf[0], qf[1]);
        mma_bf16(st[2 * n2 + 1], kf, qf[2], qf[3]);
        mma_bf16(dpt[2 * n2], vf, gf[0], gf[1]);
        mma_bf16(dpt[2 * n2 + 1], vf, gf[2], gf[3]);
      }
    }

    // scale, mask (edge steps only), P^T and dS^T in place
    const bool edge = !(n0 + BR <= n_hi && j0 + BC <= a.Skv &&
                        n0 / G + qoff >= j0 + BC - 1 &&
                        (a.window <= 0 || (n0 + BR - 1) / G + qoff - j0 < a.window));
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * t4 + (e & 1);  // the row's place in the step
        float x = st[n][e] * a.scale;
        if (edge) {
          const int row = n0 + r, j = ja[e >> 1], dist = row / G + qoff - j;
          const bool ok = row < n_hi && j < a.Skv && dist >= 0 &&
                          (a.window <= 0 || dist < a.window);
          x = ok ? x : -1e30f;
        }
        const float p = expf(x - lst[r]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dst[r]);
      }

    // dV += P^T dout, dK += dS^T Q: the score tiles are the A fragments,
    // hi then lo; dout and Q are the B operands, read transposed
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_a(st[2 * kk], st[2 * kk + 1], ph, pl);
      split_a(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + c0 + d2 * 16 +
                        (lane >> 4) * 8;
        uint32_t f[4];
        ldsm_x4_t(smem_addr(gst + off), f);
        mma_bf16(dv[2 * d2], ph, f[0], f[1]);
        mma_bf16(dv[2 * d2], pl, f[0], f[1]);
        mma_bf16(dv[2 * d2 + 1], ph, f[2], f[3]);
        mma_bf16(dv[2 * d2 + 1], pl, f[2], f[3]);
        ldsm_x4_t(smem_addr(qst + off), f);
        mma_bf16(dk[2 * d2], sh, f[0], f[1]);
        mma_bf16(dk[2 * d2], sl, f[0], f[1]);
        mma_bf16(dk[2 * d2 + 1], sh, f[2], f[3]);
        mma_bf16(dk[2 * d2 + 1], sl, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = ja[i];
    if (j >= a.Skv) continue;
    const long long at = (((long long)b * a.Skv + j) * a.Hkv + kvh) * HD + c0 + 2 * t4;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + at + d * 8) =
          __floats2bfloat162_rn(dk[d][2 * i] * a.scale, dk[d][2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + at + d * 8) =
          __floats2bfloat162_rn(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) bwd_tc_dq_kernel(Args a) {
  constexpr int P = HD + 8;
  constexpr int CH = HD / 8;
  constexpr int TK = dq_tile<HD>();
  constexpr int NK = TK / 8;  // 8-key score tiles
  constexpr int DH = grad_cols<HD>();
  constexpr int ND = DH / 8;  // 8-wide dQ column tiles
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* qs = smem;               // [RQ][P]
  __nv_bfloat16* gs = qs + RQ * P;        // [RQ][P]: dout
  __nv_bfloat16* ks = gs + RQ * P;        // [2][TK][P]
  __nv_bfloat16* vs = ks + 2 * TK * P;    // [2][TK][P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.G, nrows = a.Sq * G, qoff = a.Skv - a.Sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * RQ;  // late rows (most keys) first
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int c0 = blockIdx.z * DH;  // this block's columns of dQ
  const __nv_bfloat16* qb = a.q + b * a.qsb + (long long)kvh * G * a.qsh;
  const __nv_bfloat16* kb = a.k + b * a.ksb + kvh * a.ksh;
  const __nv_bfloat16* vb = a.v + b * a.vsb + kvh * a.vsh;

  for (int e = tid; e < RQ * CH; e += NT) {
    const int r = e / CH, c = e % CH, n = r0 + r;
    const bool ok = n < nrows;
    const long long pos = n / G, hg = n % G;
    cp_async16(smem_addr(qs + r * P + c * 8), ok ? qb + pos * a.qss + hg * a.qsh + c * 8 : qb,
               ok);
    cp_async16(smem_addr(gs + r * P + c * 8),
               ok ? a.dout + (((long long)b * a.Sq + pos) * a.Hq + kvh * G + hg) * HD + c * 8
                  : a.dout,
               ok);
  }
  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* kd = ks + stage * TK * P;
    __nv_bfloat16* vd = vs + stage * TK * P;
    for (int e = tid; e < TK * CH; e += NT) {
      const int r = e / CH, c = e % CH, j = t * TK + r;
      const bool ok = j < a.Skv;
      cp_async16(smem_addr(kd + r * P + c * 8), ok ? kb + (long long)j * a.kss + c * 8 : kb,
                 ok);
      cp_async16(smem_addr(vd + r * P + c * 8), ok ? vb + (long long)j * a.vss + c * 8 : vb,
                 ok);
    }
  };

  // keys any row of the block may see: tiles [t_lo, t_hi]
  const int n_last = min(r0 + RQ, nrows) - 1;
  const int qmin = r0 / G + qoff, qmax = n_last / G + qoff;
  const int t_lo = (a.window > 0 ? max(0, qmin - a.window + 1) : 0) / TK;
  const int t_hi = qmax / TK;
  load_kv(t_lo, 0);
  cp_async_commit();

  const int wr = warp * 16;  // this warp's first row in the block
  int qa[2];                 // absolute positions of rows g and g + 8
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = r0 + wr + g + 8 * i;
    qa[i] = n / G + qoff;
    const long long at = ((long long)b * a.Hq + kvh * G + n % G) * a.Sq + n / G;
    lse_r[i] = n < nrows ? a.lse[at] : 0.f;
    d_r[i] = n < nrows ? a.D[at] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t < t_hi) load_kv(t + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: one group per step
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * TK * P;
    const __nv_bfloat16* vst = vs + stage * TK * P;

    // S = Q K^T and dP = dout V^T for the warp's 16 rows x TK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qf[4], gf[4];
      const int a_off = (wr + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_addr(qs + a_off), qf);
      ldsm_x4(smem_addr(gs + a_off), gf);
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t kf[4], vf[4];
        const int b_off = (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(kst + b_off), kf);
        ldsm_x4(smem_addr(vst + b_off), vf);
        mma_bf16(s[2 * n2], qf, kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf, kf[2], kf[3]);
        mma_bf16(dp[2 * n2], gf, vf[0], vf[1]);
        mma_bf16(dp[2 * n2 + 1], gf, vf[2], vf[3]);
      }
    }

    // scale, mask (edge tiles only), dS in place of S. Rows past Sq * G
    // load as 0 with lse = D = 0: their dS is 0, and they are not written.
    const int j0 = t * TK;
    const bool edge = !(j0 + TK - 1 <= qmin && j0 + TK <= a.Skv &&
                        (a.window <= 0 || qmax - j0 < a.window));
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
        const float p = expf(x - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - d_r[e >> 1]);
      }

    // dQ += dS K: dS tiles are the A fragments, hi then lo; K read transposed
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_a(s[2 * kk], s[2 * kk + 1], sh, sl);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t f[4];
        ldsm_x4_t(smem_addr(kst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                            c0 + d2 * 16 + (lane >> 4) * 8),
                  f);
        mma_bf16(dq[2 * d2], sh, f[0], f[1]);
        mma_bf16(dq[2 * d2], sl, f[0], f[1]);
        mma_bf16(dq[2 * d2 + 1], sh, f[2], f[3]);
        mma_bf16(dq[2 * d2 + 1], sl, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = r0 + wr + g + 8 * i;
    if (n >= nrows) continue;
    __nv_bfloat16* row =
        a.dq + (((long long)b * a.Sq + n / G) * a.Hq + kvh * G + n % G) * HD + c0 + 2 * t4;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8) =
          __floats2bfloat162_rn(dq[d][2 * i] * a.scale, dq[d][2 * i + 1] * a.scale);
  }
}

template <int HD>
int launch_t(const Args& a, cudaStream_t st) {
  constexpr size_t P = HD + 8;
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  bwd_tc_d_kernel<HD><<<(unsigned)((rows + NWARP - 1) / NWARP), NT, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = 2 * (2 * BC + 4 * BR) * P + 4 * 4 * BR;
  err = cudaFuncSetAttribute(bwd_tc_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned)(a.B * a.Hkv), (unsigned)((a.Skv + BC - 1) / BC),
                     (unsigned)(HD / grad_cols<HD>()));
  bwd_tc_dkdv_kernel<HD><<<grid_kv, NT, smem_kv, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = 2 * (2 * RQ + 4 * dq_tile<HD>()) * P;
  err = cudaFuncSetAttribute(bwd_tc_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned)(a.B * a.Hkv),
                    (unsigned)(((long long)a.Sq * a.G + RQ - 1) / RQ),
                    (unsigned)(HD / grad_cols<HD>()));
  bwd_tc_dq_kernel<HD><<<grid_q, NT, smem_q, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only. q, k, v are read through their (B, S, H) strides (in elements,
// each a multiple of 8; the head dimension dense); out, dout and dq are
// dense (B, Sq, Hq, hd), dk and dv dense (B, Skv, Hkv, hd), lse and the D
// scratch dense fp32 (B, Hq, Sq); every bf16 pointer 16-byte aligned. Three
// launches on one stream: D, then dk and dv, then dq.
extern "C" int flashattn_bwd_tc_launch(const void* q, const void* k, const void* v,
                                       const void* out, const float* lse,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       float* D, int B, int Sq, int Skv, int Hq,
                                       int Hkv, int hd, int window, float scale,
                                       long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh,
                                       void* stream) {
  const long long strides[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, v, out, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (B < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sq > Skv ||
      (long long)B * Hkv > (1LL << 31) - 1 || ((long long)Skv + BC - 1) / BC > 65535 ||
      ((long long)Sq * (Hq / Hkv) + RQ - 1) / RQ > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(out), lse,
         static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq),
         static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), D,
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
