"""Mamba-2 SSD chunked scan: the CUDA kernel on the card, the plain torch
version on the CPU (``ops``), and the sequential oracle (``ref``)."""

from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_fwd  # noqa: F401
from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: F401
