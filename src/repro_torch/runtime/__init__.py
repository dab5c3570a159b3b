"""Runtime substrate: straggler watchdog + elastic mesh planning.

Counterpart of ``repro.runtime``.
"""

from repro_torch.runtime.elastic import (RescalePlan, elastic_mesh_shape,
                                         make_mesh_from_plan, plan_rescale)
from repro_torch.runtime.watchdog import StepWatchdog, StragglerAlert

__all__ = ["RescalePlan", "StepWatchdog", "StragglerAlert",
           "elastic_mesh_shape", "make_mesh_from_plan", "plan_rescale"]
