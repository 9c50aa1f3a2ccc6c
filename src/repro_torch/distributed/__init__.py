"""Distribution: sharding rules, step builders, fault tolerance,
elasticity, over ``torch.distributed`` (the reference's
``repro.distributed``)."""

from repro_torch.distributed.compress import (
    compress_grads,
    compressed_wire_bytes,
    init_error_feedback,
    uncompressed_wire_bytes,
)
from repro_torch.distributed.elastic import (ElasticPlan,
                                             build_mesh_from_plan, plan_mesh)
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor,
    RestartPolicy,
    StragglerMitigator,
)

__all__ = [
    "compress_grads", "init_error_feedback",
    "compressed_wire_bytes", "uncompressed_wire_bytes",
    "ElasticPlan", "plan_mesh", "build_mesh_from_plan",
    "HeartbeatMonitor", "StragglerMitigator", "RestartPolicy",
]
