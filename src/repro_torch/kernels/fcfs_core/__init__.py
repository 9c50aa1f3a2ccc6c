"""Batched open-loop fast path: the lockstep shard core.

``ops.fcfs_core`` / ``ops.fused_core`` are the dispatch entries (CUDA
kernel on the card, plain torch lockstep on the CPU);
``ref.fcfs_core_ref`` is the plain-Python oracle they are held against
bit for bit.
"""

from repro_torch.kernels.fcfs_core.ops import fcfs_core, fused_core  # noqa: F401
from repro_torch.kernels.fcfs_core.ref import fcfs_core_ref  # noqa: F401
