"""Architecture registry: ``--arch <id>`` resolution for launchers and
tests, the JAX package's ``configs/__init__.py``.

Each family module (``lm``, ``gnn``, ``recsys``, ``sift100m``) keeps its
configurations and registers its ``ArchDef``s; importing them in this
order gives the reference's canonical cell order (the roofline table's).
``base`` imports no family module, so importing any of them first runs
this package's import without a cycle.
"""

from repro_torch.configs.base import ArchDef, Cell, get_arch, register  # noqa: F401

from repro_torch.configs import lm, gnn, recsys, sift100m  # noqa: F401,E401  (registration)
from repro_torch.configs.base import REGISTRY  # noqa: F401  (after registration)

ASSIGNED = [
    "llama3.2-3b",
    "gemma3-4b",
    "internlm2-1.8b",
    "moonshot-v1-16b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "gin-tu",
    "dlrm-rm2",
    "din",
    "dien",
    "two-tower-retrieval",
]
