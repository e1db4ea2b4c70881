// K6 backward: the gradient of causal / sliding-window GQA flash attention.
//
// Replaces no TPU kernel: the JAX package's Pallas K6 (src/repro/kernels/
// flashattn/kernel.py:80) has no VJP, and its training differentiates the
// XLA attention (src/repro/models/transformer.py attend_chunked). The port
// trains through K6 (kernels/flashattn/ops.py FlashAttention), so its
// backward is a kernel of its own. It computes kernels/flashattn/ref.py
// flash_attention_bwd_ref: from q, k, v, the forward's out and per-row
// log-sum-exp lse (fp32, (B, Hq, Sq)) and the output's gradient dout, with
// the forward's scores s = (q . k) * scale, mask (-1e30 unless
// 0 <= (i + Skv - Sq) - j < window, no upper limit when window <= 0):
//
//   P = exp(s - lse)   D = rowsum(dout * out)   dS = P * (dout V^T - D)
//   dq = scale dS K    dk = scale sum_g dS^T Q   dv = sum_g P^T dout
//
// in fp32 FMAs on the CUDA cores, for fp32 and bf16 inputs (converted
// exactly to fp32 on load) at hd 8..256, each gradient rounded to the input
// type once. expf and IEEE arithmetic, no fast math.
//
// Bound on the H100: at the training step's shape (B 2, S 4096, 16 query
// heads over 8 KV heads, hd 128, bf16) the five products of the gradient
// cost 2 * 5 * hd flops a (query, key) pair of the causal half, 344 GFLOP:
// 0.35 ms at the bf16 tensor-core peak, 5.1 ms at the fp32 FMA peak (67
// TFLOP/s), which is this kernel's own ceiling. The design computes S and
// dP in both passes (seven products, not five) to stay free of atomics;
// mma.sync / wgmma on bf16 tiles are the next step.
//
// Design. Deterministic: no floating-point atomics, every output element is
// summed by one thread in one order.
//  * flashattn_bwd_d_kernel: D, one warp a (batch, position, head) row.
//  * flashattn_bwd_dkdv_kernel: one block owns a tile of BC keys of one
//    (batch, KV head) and loops over every query row of its group that can
//    see them (rows are the flattened (position, head-in-group) pairs, as in
//    the forward, so dk and dv sum over the group inside the block), BR
//    rows a step: S and dP for the tile (each thread an RT x CT piece),
//    then dv += P^T dout and dk += dS^T q in registers (each thread KPT
//    keys x a few float4 columns).
//  * flashattn_bwd_dq_kernel: one block owns BR query rows and loops over
//    the key tiles they can see: S, dP, then dq += dS K in registers.
// Tiles of q, dout, k and v live row-major in shared memory, each row
// padded by 4 floats: the score loops read float4s along hd (a thread's
// key columns 16 apart, so a quarter-warp's float4s fall in distinct
// banks), the sums read a float4 of P or dS and float4s of a row. Key tiles
// wholly outside every row's reach (above the diagonal, past the window)
// are skipped, as in the forward. Heavy tiles start first (low key tiles
// in the dk/dv pass, late query tiles in the dq pass).
//
// Device: launches on the current device, which the wrapper makes the
// tensors' own; it sets its shared-memory sizes on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads a block: 16 x 16 for the score tiles
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // dense (B, Sq, Hq, hd)
  const float* lse;  // dense (B, Hq, Sq)
  const void* dout;  // dense (B, Sq, Hq, hd)
  void* dq;          // dense (B, Sq, Hq, hd)
  void* dk;          // dense (B, Skv, Hkv, hd)
  void* dv;
  float* D;  // scratch, dense (B, Hq, Sq)
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
  *p = __float2bfloat16(x);  // round to nearest even, once
}

// N consecutive floats of shared memory (16- or 8-byte aligned for 4 or 2)
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD>
struct Cfg {
  static constexpr int BR = HD <= 128 ? 64 : 32;  // query rows a tile
  static constexpr int BC = HD <= 128 ? 64 : 32;  // keys a tile
  static constexpr int RT = BR / 16, CT = BC / 16;  // score piece a thread
  static constexpr int P = HD + 4;                  // row pitch of the tiles
  static constexpr int PR = BR + 4, PC = BC + 4;    // pitches of P, dS
  static constexpr int C4 = HD / 4;                 // float4 columns a row
  static constexpr int TD = C4 < 16 ? C4 : 16;      // threads along hd (sums)
  static constexpr int TE = NT / TD;                // threads along rows/keys
  static constexpr int X4 = C4 / TD;                // float4 columns a thread
  static constexpr int KPT = BC >= TE ? BC / TE : 1;  // keys a thread (dk, dv)
  static constexpr int RPT = BR >= TE ? BR / TE : 1;  // rows a thread (dq)
};

// D[b, h, i] = sum_d dout * out, one warp a row of the dense (B, Sq, Hq)
// order.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flashattn_bwd_d_kernel(Args a) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Sq * a.Hq) return;
  const T* o = static_cast<const T*>(a.o) + row * HD;
  const T* g = static_cast<const T*>(a.dout) + row * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) s = fmaf(ld(g + d), ld(o + d), s);
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) s += __shfl_xor_sync(FULL, s, w);
  if (lane == 0) {
    const int h = (int)(row % a.Hq);
    const long long bp = row / a.Hq;
    a.D[((bp / a.Sq) * a.Hq + h) * a.Sq + bp % a.Sq] = s;
  }
}

// NR rows of q (or dout, with DENSE) of one (batch, KV head) from the
// flattened row n0 into dst[r * P + d]; rows past hi load as 0.
template <typename T, int HD, int NR, bool DENSE>
__device__ __forceinline__ void load_rows(float* dst, const T* base, const Args& a,
                                          int b, int kvh, int n0, int hi) {
  using C = Cfg<HD>;
  for (int e = threadIdx.x; e < NR * C::C4; e += NT) {
    const int r = e / C::C4, d = (e % C::C4) * 4;
    const int n = n0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < hi) {
      const int pos = n / a.G, g = n % a.G;
      const T* src = DENSE ? base + (((long long)b * a.Sq + pos) * a.Hq + kvh * a.G + g) * HD
                           : base + b * a.qsb + (long long)pos * a.qss +
                                 (long long)(kvh * a.G + g) * a.qsh;
      x = make_float4(ld(src + d), ld(src + d + 1), ld(src + d + 2), ld(src + d + 3));
    }
    *reinterpret_cast<float4*>(dst + r * C::P + d) = x;
  }
}

// NC keys of k or v from key j0 into dst[c * P + d]; keys past Skv load 0.
template <typename T, int HD, int NC>
__device__ __forceinline__ void load_keys(float* dst, const T* base, long long sb,
                                          long long ss, long long sh, const Args& a,
                                          int b, int kvh, int j0) {
  using C = Cfg<HD>;
  for (int e = threadIdx.x; e < NC * C::C4; e += NT) {
    const int c = e / C::C4, d = (e % C::C4) * 4;
    const int j = j0 + c;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < a.Skv) {
      const T* src = base + b * sb + (long long)j * ss + kvh * sh + d;
      x = make_float4(ld(src), ld(src + 1), ld(src + 2), ld(src + 3));
    }
    *reinterpret_cast<float4*>(dst + c * C::P + d) = x;
  }
}

// Each row's lse and D of a query tile into shared memory (0 past hi).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* d_s, int nr,
                                               const Args& a, int b, int kvh,
                                               int n0, int hi) {
  for (int r = threadIdx.x; r < nr; r += NT) {
    const int n = n0 + r;
    float l = 0.f, dd = 0.f;
    if (n < hi) {
      const long long at = ((long long)b * a.Hq + kvh * a.G + n % a.G) * a.Sq + n / a.G;
      l = a.lse[at];
      dd = a.D[at];
    }
    lse_s[r] = l;
    d_s[r] = dd;
  }
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// The thread's RT x CT piece of P and dS -- rows ty * RT + i, keys
// tx + 16 j of the tiles -- for query rows n0.. and keys j0..: s = q . k,
// dp = dout . v, then the mask, P = exp(s * scale - lse) (exactly 0 where
// masked) and dS = P (dp - D).
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       const float* lse_s, const float* d_s,
                                       const Args& a, int n0, int j0,
                                       float (&p)[Cfg<HD>::RT][Cfg<HD>::CT],
                                       float (&ds)[Cfg<HD>::RT][Cfg<HD>::CT]) {
  using C = Cfg<HD>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[C::RT][C::CT], dp[C::RT][C::CT];
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int j = 0; j < C::CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < HD; d += 4) {
    float4 xr[C::RT], xc[C::CT];  // s's operands, then dp's
#pragma unroll
    for (int i = 0; i < C::RT; ++i) xr[i] = ld4(qs + (ty * C::RT + i) * C::P + d);
#pragma unroll
    for (int j = 0; j < C::CT; ++j) xc[j] = ld4(ks + (tx + 16 * j) * C::P + d);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::CT; ++j) s[i][j] = dot4(xr[i], xc[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < C::RT; ++i) xr[i] = ld4(gs + (ty * C::RT + i) * C::P + d);
#pragma unroll
    for (int j = 0; j < C::CT; ++j) xc[j] = ld4(vs + (tx + 16 * j) * C::P + d);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::CT; ++j) dp[i][j] = dot4(xr[i], xc[j], dp[i][j]);
  }
  const int nrows = a.Sq * a.G, qoff = a.Skv - a.Sq;
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int r = ty * C::RT + i, n = n0 + r;
    const int pos = n / a.G + qoff;
    const float l = lse_s[r], dd = d_s[r];
#pragma unroll
    for (int j = 0; j < C::CT; ++j) {
      const int kj = j0 + tx + 16 * j, dist = pos - kj;
      const bool ok = n < nrows && kj < a.Skv && dist >= 0 &&
                      (a.window <= 0 || dist < a.window);
      const float x = ok ? s[i][j] * a.scale : -1e30f;
      p[i][j] = expf(x - l);
      ds[i][j] = p[i][j] * (dp[i][j] - dd);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flashattn_bwd_dkdv_kernel(Args a) {
  using C = Cfg<HD>;
  constexpr int KPT = C::KPT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [BC][P]
  float* vs = ks + C::BC * C::P;       // [BC][P]
  float* qs = vs + C::BC * C::P;       // [BR][P]
  float* gs = qs + C::BR * C::P;       // [BR][P]: dout
  float* ps = gs + C::BR * C::P;       // [BR][PC]: P
  float* dss = ps + C::BR * C::PC;     // [BR][PC]: dS
  float* lse_s = dss + C::BR * C::PC;  // [BR]
  float* d_s = lse_s + C::BR;          // [BR]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int e = tid / C::TD, dd = tid % C::TD;  // the sums: keys e * KPT.., columns dd
  const bool sums = e * KPT < C::BC;
  const int j0 = blockIdx.x * C::BC;  // low key tiles (the most rows) first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int G = a.G, nrows = a.Sq * G, qoff = a.Skv - a.Sq;
  const T* q = static_cast<const T*>(a.q);
  const T* g = static_cast<const T*>(a.dout);
  load_keys<T, HD, C::BC>(ks, static_cast<const T*>(a.k), a.ksb, a.kss, a.ksh, a, b,
                          kvh, j0);
  load_keys<T, HD, C::BC>(vs, static_cast<const T*>(a.v), a.vsb, a.vss, a.vsh, a, b,
                          kvh, j0);

  // query rows that see a key of the tile: positions in [j0, j0 + BC - 2 +
  // window] (no upper limit without a window)
  const int n_lo = max(0, j0 - qoff) * G;
  const int n_hi = a.window > 0
                       ? (int)min((long long)nrows,
                                  max(0LL, ((long long)j0 + C::BC - 1 + a.window - qoff) * G))
                       : nrows;
  float dk[KPT][C::X4 * 4], dv[KPT][C::X4 * 4];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int x = 0; x < C::X4 * 4; ++x) dk[j][x] = dv[j][x] = 0.f;

  for (int n0 = n_lo; n0 < n_hi; n0 += C::BR) {
    __syncthreads();  // the previous step's readers are done
    load_rows<T, HD, C::BR, false>(qs, q, a, b, kvh, n0, n_hi);
    load_rows<T, HD, C::BR, true>(gs, g, a, b, kvh, n0, n_hi);
    load_row_stats(lse_s, d_s, C::BR, a, b, kvh, n0, n_hi);
    __syncthreads();
    float p[C::RT][C::CT], ds[C::RT][C::CT];
    scores<HD>(qs, gs, ks, vs, lse_s, d_s, a, n0, j0, p, ds);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::CT; ++j) {
        ps[(ty * C::RT + i) * C::PC + tx + 16 * j] = p[i][j];
        dss[(ty * C::RT + i) * C::PC + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    if (sums) {
      for (int r = 0; r < C::BR; ++r) {
        float pp[KPT], sg[KPT];
        lds(ps + r * C::PC + e * KPT, pp);
        lds(dss + r * C::PC + e * KPT, sg);
#pragma unroll
        for (int x = 0; x < C::X4; ++x) {
          const float4 gv = ld4(gs + r * C::P + 4 * (dd + C::TD * x));
          const float4 qv = ld4(qs + r * C::P + 4 * (dd + C::TD * x));
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            dv[j][4 * x + 0] = fmaf(pp[j], gv.x, dv[j][4 * x + 0]);
            dv[j][4 * x + 1] = fmaf(pp[j], gv.y, dv[j][4 * x + 1]);
            dv[j][4 * x + 2] = fmaf(pp[j], gv.z, dv[j][4 * x + 2]);
            dv[j][4 * x + 3] = fmaf(pp[j], gv.w, dv[j][4 * x + 3]);
            dk[j][4 * x + 0] = fmaf(sg[j], qv.x, dk[j][4 * x + 0]);
            dk[j][4 * x + 1] = fmaf(sg[j], qv.y, dk[j][4 * x + 1]);
            dk[j][4 * x + 2] = fmaf(sg[j], qv.z, dk[j][4 * x + 2]);
            dk[j][4 * x + 3] = fmaf(sg[j], qv.w, dk[j][4 * x + 3]);
          }
        }
      }
    }
  }

  if (!sums) return;
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kj = j0 + e * KPT + j;
    if (kj >= a.Skv) continue;
    const long long at = (((long long)b * a.Skv + kj) * a.Hkv + kvh) * HD;
#pragma unroll
    for (int x = 0; x < C::X4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int d = 4 * (dd + C::TD * x) + y;
        put(dkp + at + d, dk[j][4 * x + y] * a.scale);
        put(dvp + at + d, dv[j][4 * x + y]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flashattn_bwd_dq_kernel(Args a) {
  using C = Cfg<HD>;
  constexpr int RPT = C::RPT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BR][P]
  float* gs = qs + C::BR * C::P;       // [BR][P]: dout
  float* ks = gs + C::BR * C::P;       // [BC][P]
  float* vs = ks + C::BC * C::P;       // [BC][P]
  float* dst = vs + C::BC * C::P;      // [BC][PR]: dS, transposed
  float* lse_s = dst + C::BC * C::PR;  // [BR]
  float* d_s = lse_s + C::BR;          // [BR]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int e = tid / C::TD, dd = tid % C::TD;  // the sum: rows e * RPT.., columns dd
  const bool sums = e * RPT < C::BR;
  const int G = a.G, nrows = a.Sq * G, qoff = a.Skv - a.Sq;
  const int n0 = (gridDim.x - 1 - blockIdx.x) * C::BR;  // late rows (most keys) first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  load_rows<T, HD, C::BR, false>(qs, static_cast<const T*>(a.q), a, b, kvh, n0, nrows);
  load_rows<T, HD, C::BR, true>(gs, static_cast<const T*>(a.dout), a, b, kvh, n0, nrows);
  load_row_stats(lse_s, d_s, C::BR, a, b, kvh, n0, nrows);

  // keys any row of the tile may see: tiles [t_lo, t_hi]
  const int qmin = n0 / G + qoff, qmax = (min(n0 + C::BR, nrows) - 1) / G + qoff;
  const int t_lo = (a.window > 0 ? max(0, qmin - a.window + 1) : 0) / C::BC;
  const int t_hi = qmax / C::BC;
  float acc[RPT][C::X4 * 4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int x = 0; x < C::X4 * 4; ++x) acc[i][x] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int j0 = t * C::BC;
    __syncthreads();  // the previous tile's readers are done
    load_keys<T, HD, C::BC>(ks, static_cast<const T*>(a.k), a.ksb, a.kss, a.ksh, a, b,
                            kvh, j0);
    load_keys<T, HD, C::BC>(vs, static_cast<const T*>(a.v), a.vsb, a.vss, a.vsh, a, b,
                            kvh, j0);
    __syncthreads();
    float p[C::RT][C::CT], ds[C::RT][C::CT];
    scores<HD>(qs, gs, ks, vs, lse_s, d_s, a, n0, j0, p, ds);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::CT; ++j)
        dst[(tx + 16 * j) * C::PR + ty * C::RT + i] = ds[i][j];
    __syncthreads();
    if (sums) {
      for (int c = 0; c < C::BC; ++c) {
        float sg[RPT];
        lds(dst + c * C::PR + e * RPT, sg);
#pragma unroll
        for (int x = 0; x < C::X4; ++x) {
          const float4 kv = ld4(ks + c * C::P + 4 * (dd + C::TD * x));
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc[i][4 * x + 0] = fmaf(sg[i], kv.x, acc[i][4 * x + 0]);
            acc[i][4 * x + 1] = fmaf(sg[i], kv.y, acc[i][4 * x + 1]);
            acc[i][4 * x + 2] = fmaf(sg[i], kv.z, acc[i][4 * x + 2]);
            acc[i][4 * x + 3] = fmaf(sg[i], kv.w, acc[i][4 * x + 3]);
          }
        }
      }
    }
  }

  if (!sums) return;
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = n0 + e * RPT + i;
    if (n >= nrows) continue;
    const long long at = (((long long)b * a.Sq + n / G) * a.Hq + kvh * G + n % G) * HD;
#pragma unroll
    for (int x = 0; x < C::X4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        put(dqp + at + 4 * (dd + C::TD * x) + y, acc[i][4 * x + y] * a.scale);
  }
}

template <typename T, int HD>
int launch_t(const Args& a, cudaStream_t st) {
  using C = Cfg<HD>;
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  flashattn_bwd_d_kernel<T, HD>
      <<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = sizeof(float) * ((size_t)2 * C::BC * C::P + (size_t)2 * C::BR * C::P +
                                          (size_t)2 * C::BR * C::PC + 2 * C::BR);
  err = cudaFuncSetAttribute(flashattn_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned)((a.Skv + C::BC - 1) / C::BC), (unsigned)(a.B * a.Hkv));
  flashattn_bwd_dkdv_kernel<T, HD><<<grid_kv, NT, smem_kv, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * ((size_t)2 * C::BR * C::P + (size_t)2 * C::BC * C::P +
                                         (size_t)C::BC * C::PR + 2 * C::BR);
  err = cudaFuncSetAttribute(flashattn_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned)(((long long)a.Sq * a.G + C::BR - 1) / C::BR),
                    (unsigned)(a.B * a.Hkv));
  flashattn_bwd_dq_kernel<T, HD><<<grid_q, NT, smem_q, st>>>(a);
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

// dtype: 0 = fp32, 1 = bf16. q, k, v are read through their (B, S, H)
// strides (in elements; the head dimension dense); out, dout and dq are
// dense (B, Sq, Hq, hd), dk and dv dense (B, Skv, Hkv, hd), lse and the D
// scratch dense fp32 (B, Hq, Sq). Three launches on one stream: D, then
// dk and dv, then dq.
extern "C" int flashattn_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* out, const float* lse,
                                    const void* dout, void* dq, void* dk, void* dv,
                                    float* D, int B, int Sq, int Skv, int Hq,
                                    int Hkv, int hd, int window, int dtype,
                                    float scale, long long qsb, long long qss,
                                    long long qsh, long long ksb, long long kss,
                                    long long ksh, long long vsb, long long vss,
                                    long long vsh, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sq > Skv ||
      (long long)B * Hkv > 65535 || (long long)Sq * (Hq / Hkv) > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, lse, dout, dq, dk, dv, D, B, Sq, Skv, Hq, Hkv, Hq / Hkv,
         window, scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, hd, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, hd, st);
  return (int)cudaErrorInvalidValue;
}
