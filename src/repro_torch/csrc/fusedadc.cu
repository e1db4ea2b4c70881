// K5: whole-shard fused ADC scan with in-kernel k-selection (codes).
//
// Replaces the TPU kernel fusedadc_kernel (+ _select_and_carry), launched
// by fusedadc_pallas (src/repro/kernels/fusedscan/kernel.py). Computes
// kernels/fusedscan/ref.py fused_adc_topk_ref: for every lookup row the k
// smallest d2 = sum_j lut[q, j, codes[p, j]] over the live (id >= 0) rows
// of its leaf in the whole leaf-sorted shard, ascending by (distance, shard
// row), ids mapped through point_ids, inf / -1 where fewer than k match.
//
// Bound on the H100: ADC is gathers and adds, so the bound is bytes: each
// lookup row's 8 KiB LUT read once where its leaf holds a row (at most the
// 256 MiB LUT of the main path), the codes, leaves and ids of the rows of
// the leaves the lookup holds, and the (Q, k) output (32 MiB at k = 128):
// about 0.15 ms at the main path's call.
//
// Design: K5 is K4's kernel (adcscan.cu) over the whole shard, with P the
// shard's rows, no slab start, and the FUSED instantiation: a block owns a
// lookup row; its run search takes 5 warp-wide rounds of loads over 2^25
// rows (in place of 25 dependent loads of one lane), it stages the LUT
// only for a non-empty run, and it skips tombstones (id < 0), which keep
// their leaf so that the leaves stay sorted (the TPU path masked their
// leaves instead, which breaks that order). Its selection differs from
// the wave's: K4's 8 warps each fill and merge a list of k, which at
// 2,100 rows a lookup row (the main path's mean; 30,000 at most) cost far
// more than the distances (K4's kernel as it is took 2.15 ms here, against
// 3.36 before: chip_smoke.py, H100 80GB HBM3 at 700 W). So one warp scans the run 128 rows a step, 4 a lane, their
// codes fetched a step ahead as one 8-byte load a row, and the candidates
// that beat the k-th entry wait in a buffer that is merged into the one
// list 32 at a time (warp_merge_offer): about 15 merges a lookup row in
// place of about 94. The selection is the same (the k smallest by
// (distance, row)), so the fused and the wave-sweep codes paths agree bit
// for bit. k <= 128 at KCAP 128, 128 < k <= 256 (the wide range) at KCAP
// 256; kernels/fusedscan/ops.py sends a larger k to the block list kernel
// (widetopk.cu). The row count stays 32-bit (the wrapper checks P < 2^31).
#include "common.cuh"

int adcscan_run(bool fused, const void* codes, const void* pleaves,
                const void* pids, const void* lut, const void* qleaves,
                const void* q_start, void* out_d, void* out_i, int P, int Q,
                int n_lut, int m, int C, int k, void* stream);

extern "C" int fusedadc_launch(const void* codes, const void* pleaves,
                               const void* pids, const void* lut,
                               const void* qleaves, void* out_d, void* out_i,
                               int P, int Q, int m, int C, int k,
                               void* stream) {
  return adcscan_run(true, codes, pleaves, pids, lut, qleaves, nullptr, out_d,
                     out_i, P, Q, Q, m, C, k, stream);
}
