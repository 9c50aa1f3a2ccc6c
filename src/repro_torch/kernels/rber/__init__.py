"""RBER table of a page population over a retry table: the CUDA kernel on
the card, the plain torch version on the CPU (``ops``)."""

from repro_torch.kernels.rber.ops import rber_fwd, rber_table  # noqa: F401
from repro_torch.kernels.rber.plain import PAGE_MASKS, rber_plain  # noqa: F401
