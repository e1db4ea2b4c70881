"""PyTorch/CUDA port of the vocabulary-tree indexing and batch search
system (paper sections 2.3-2.4), for one NVIDIA H100.

The main path is ``build_tree -> build_index -> batch_search``, at the
point-major or the query-routed layout, or ``"auto"`` through the cost
model (``core.engine.costmodel``). ``Index`` is the paper's growing
collection: ``create -> append -> commit -> open -> delete -> compact ->
search`` over immutable on-disk segments, in the JAX package's directory
format, with ``ShardedIndex`` to scatter a search over its segments. The
compressed-codes path trains a ``codes.ProductQuantizer`` on the index,
encodes its rows, scans the codes (``search_with_lookup`` with a
``scan_codes`` plan) and reranks the survivors exactly
(``codes.rerank_exact``), or ``Index.enable_codes`` then
``Index.search(layout="scan_codes")``. The model side serves a dense decoder LM
(``models.transformer``: ``prefill`` then ``decode_step``). Every entry
point runs on the card unless the caller passes ``device="cpu"``; on a
CUDA tensor the hot loops go through hand-written CUDA kernels
(``kernels/l2nn``, ``kernels/l2topk``, ``kernels/fusedscan``,
``kernels/adcscan``, ``kernels/flashattn``, sources in ``csrc/``), built
with ``nvcc`` at first use. On a CPU tensor each kernel wrapper runs its
plain PyTorch version.

This package imports torch and numpy only.
"""

from repro_torch.codes import IndexRowReader, ProductQuantizer, rerank_exact  # noqa: F401
from repro_torch.core.engine import SearchPlan, SearchResult, plan  # noqa: F401
from repro_torch.core.index_build import DistributedIndex, build_index  # noqa: F401
from repro_torch.core.lookup import LookupTable, build_lookup, probe_leaves  # noqa: F401
from repro_torch.core.search import batch_search, search_with_lookup  # noqa: F401
from repro_torch.core.tree import VocabTree, build_tree, tree_assign  # noqa: F401
from repro_torch.index import Index, ShardedIndex, ShardPlan  # noqa: F401
