"""Decoder LM of the serving path: attention and dense-MLP blocks over
stacked units, with prefill attention through the flash-attention kernel."""

from repro_torch.models.api import Model, build_model  # noqa: F401
