"""Parameters of the JAX reference as the port's parameters.

``params_from_jax`` takes the reference's parameter pytree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the same nested dicts and lists of torch tensors on ``device``: the
layouts already agree (stacked units, ``(d, H, hd)`` projections), so
both packages compute the same function of the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree, device=None):
    """Nested dicts / lists / tuples of numpy arrays -> torch tensors on
    ``device`` (``None``: the CUDA card), dtypes kept."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)
