"""Training: AdamW, gradient compression, microbatched train steps (the
JAX package's ``repro.train``)."""

from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: F401
from repro_torch.train.step import make_train_step  # noqa: F401
