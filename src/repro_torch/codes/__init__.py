"""Compressed-codes tier: PQ encoder + exact rerank."""

from repro_torch.codes.pq import CODES_FORMAT, ProductQuantizer  # noqa: F401
from repro_torch.codes.rerank import IndexRowReader, rerank_exact  # noqa: F401
