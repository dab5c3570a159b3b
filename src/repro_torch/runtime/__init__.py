"""Runtime substrate: straggler watchdog + elastic mesh planning.

Counterpart of ``repro.runtime``. Building a mesh from a plan
(``make_mesh_from_plan``) comes with the device mesh (ROADMAP A9).
"""

from repro_torch.runtime.elastic import (RescalePlan, elastic_mesh_shape,
                                         plan_rescale)
from repro_torch.runtime.watchdog import StepWatchdog, StragglerAlert

__all__ = ["RescalePlan", "StepWatchdog", "StragglerAlert",
           "elastic_mesh_shape", "plan_rescale"]
