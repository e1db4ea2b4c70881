"""Same-leaf ADC top-k tile wrapper: the plain version for a CPU tensor,
the K4 CUDA kernel (``csrc/adcscan.cu``) for a CUDA tensor.

The kernel walks exactly the ``P`` code rows and ``Q`` lookup rows it is
given, one warp per lookup row, so nothing is padded; in the wave sweep it
is given the whole LUT and the slab's start on the device, and reads only
the LUTs of the slab rows whose leaf the wave holds. The sentinels keep
their meaning: a point leaf of ``PAD_TILE_POINT_LEAF`` (a tombstone the
executor masked) or ``LEAF_SENTINEL`` and a padded lookup row's
``PAD_QUERY_LEAF`` never equal a real leaf or each other.
"""

from __future__ import annotations

import torch

from repro_torch.device import check_kernel_inputs
from repro_torch.kernels import _build
from repro_torch.kernels.adcscan.ref import adc_topk_ref

MAX_K = 128  # csrc/common.cuh ADC_KCAP: the largest rerank depth
# one warp's LUT and list must fit a block's shared memory (csrc/common.cuh)
MAX_SMEM = 227 * 1024 - 64


def check_adc_shapes(name: str, codes, point_leaves, lut, query_leaves, k,
                     point_ids=None) -> None:
    """Raise unless the shapes and ``k`` are ones the ADC kernels take."""
    P, m = codes.shape
    Q, lm, C = lut.shape
    if (lm != m or point_leaves.shape != (P,) or query_leaves.shape != (Q,)
            or (point_ids is not None and point_ids.shape != (P,))):
        raise ValueError(f"{name}: mismatched shapes")
    if m < 1 or C < 1 or Q < 1 or not 1 <= k <= min(MAX_K, P):
        raise ValueError(f"{name}: unsupported {P=} {Q=} {m=} {C=} {k=}")
    if 4 * (m * C + 2 * k) > MAX_SMEM:
        raise ValueError(f"{name}: a {m} x {C} LUT does not fit shared memory")


def adc_topk(codes: torch.Tensor, point_leaves: torch.Tensor,
             lut: torch.Tensor, query_leaves: torch.Tensor, *, k: int,
             q_start: torch.Tensor | None = None, q_rows: int | None = None):
    """(dists (Q,k), idx (Q,k)) of same-leaf ADC k-NN; see ref.py.

    ``codes`` (P, m) uint8, ``lut`` (Q, m, C) float32. With ``q_start``, a
    one-element int64 tensor on the codes' device, and ``q_rows``, the call
    reads only the lookup rows ``q_start .. q_start + q_rows - 1`` of
    ``lut`` and ``query_leaves`` -- a wave's slab, whose start stays on the
    device -- and returns ``(q_rows, k)`` tables; the caller keeps the
    slab inside the table (rows past its end would match nothing).
    """
    if q_start is not None and (q_start.shape != (1,)
                                or q_start.dtype != torch.int64
                                or q_start.device != codes.device
                                or not q_rows or q_rows < 1):
        raise ValueError("adc_topk: q_start must be a (1,) int64 tensor on "
                         "the codes' device, with q_rows >= 1")
    if codes.device.type == "cpu":
        if q_start is not None:
            sel = q_start + torch.arange(q_rows)
            lut, query_leaves = lut.index_select(0, sel), query_leaves.index_select(0, sel)
        return adc_topk_ref(codes, point_leaves, lut, query_leaves, k)
    if codes.device.type != "cuda":
        raise ValueError(f"adc_topk: unsupported device {codes.device}")
    check_kernel_inputs(
        "adc_topk", codes, point_leaves, lut, query_leaves,
        dtypes=(torch.uint8, torch.int32, torch.float32, torch.int32))
    check_adc_shapes("adc_topk", codes, point_leaves, lut, query_leaves, k)
    P, m = codes.shape
    n_lut, _, C = lut.shape
    Q = n_lut if q_start is None else q_rows
    out_d = torch.empty((Q, k), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=codes.device)
    err = _build.lib().adcscan_launch(
        codes.data_ptr(), point_leaves.data_ptr(), lut.data_ptr(),
        query_leaves.data_ptr(), 0 if q_start is None else q_start.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), P, Q, n_lut, m, C, k,
        _build.stream_ptr(codes))
    _build.check(err, "adcscan_launch")
    adc_topk.launches += 1
    return out_d, out_i


adc_topk.launches = 0
