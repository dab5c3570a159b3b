"""Optimizer substrate: AdamW, its schedule, and int8 gradient compression.

Counterpart of ``repro.optim``. The sharded states' specs
(``opt_state_specs``, ``abstract_opt_state``) and the compressed
all-reduce (``compressed_psum``) come with the device mesh (ROADMAP A9).
"""

from repro_torch.optim.adamw import (OptimizerConfig, adamw_update,
                                     global_norm, init_opt_state, lr_schedule)
from repro_torch.optim.compress import (compress_int8, decompress_int8,
                                        init_residuals)

__all__ = ["OptimizerConfig", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule", "compress_int8",
           "decompress_int8", "init_residuals"]
