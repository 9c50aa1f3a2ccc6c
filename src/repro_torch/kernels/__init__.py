"""Hand-written Hopper kernels of the port, each beside its plain torch
version (what CPU hosts run, and what the kernel is held against)."""
