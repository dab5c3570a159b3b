"""Optimizer substrate: AdamW (sharded states on a mesh), its schedule,
and int8 gradient compression with the compressed all-reduce.

Counterpart of ``repro.optim``.
"""

from repro_torch.optim.adamw import (OptimizerConfig, abstract_opt_state,
                                     adamw_update, global_norm,
                                     init_opt_state, lr_schedule,
                                     opt_state_specs)
from repro_torch.optim.compress import (compress_int8, compressed_psum,
                                        decompress_int8, init_residuals)

__all__ = ["OptimizerConfig", "abstract_opt_state", "adamw_update",
           "global_norm", "init_opt_state", "lr_schedule",
           "opt_state_specs", "compress_int8", "compressed_psum",
           "decompress_int8", "init_residuals"]
