"""ECC model: per-codeword correction capability and the capability margin.

The paper's reference ECC corrects t = 72 bits per 1 KiB codeword, 16
codewords per 16 KiB page.  The characterization runs in expectation
mode: a page is correctable iff its RBER is at or below t/n, and the
margin left at the final retry step is what AR² spends on a shorter
sensing time.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import constants as C


@dataclasses.dataclass(frozen=True)
class ECCConfig:
    t: int = C.ECC_T
    n_bits: int = C.ECC_N_BITS
    codewords_per_page: int = C.CODEWORDS_PER_PAGE

    @property
    def rber_cap(self) -> float:
        """Deterministic capability expressed as an RBER threshold."""
        return self.t / float(self.n_bits)


DEFAULT_ECC = ECCConfig()


def correctable(rber: torch.Tensor, ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Expectation-mode correctability: RBER within capability."""
    return rber <= torch.tensor(ecc.rber_cap, dtype=rber.dtype,
                                device=rber.device)


def capability_margin(rber: torch.Tensor,
                      ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Fraction of the ECC capability left unused at the given RBER:
    ``(t - E[errors per codeword]) / t``."""
    expected_errors = rber * ecc.n_bits
    return (ecc.t - expected_errors) / ecc.t
