from repro_torch.data.corpus import CorpusConfig, SyntheticCorpus
from repro_torch.data.flash_tier import FlashReadStats, FlashTierReader
from repro_torch.data.pipeline import PrefetchPipeline

__all__ = [
    "CorpusConfig", "SyntheticCorpus",
    "FlashTierReader", "FlashReadStats",
    "PrefetchPipeline",
]
