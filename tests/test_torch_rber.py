"""Port's RBER table (kernel B2's plain version and its entry) against the
JAX reference, and against the port's own characterization arithmetic.

Inputs are made with numpy from a seed, in the shapes of
``tests/test_kernels.py::TestRBERKernel`` (32 pages x 8 entries, 100 x
41) and a page count the reference's kernel pads (300 pages: its page
blocks are 256).  On the CPU ``rber_table`` runs the plain version, which
follows the Pallas kernel's arithmetic order.

Tolerance: rtol 1e-5, atol 1e-12.  The two packages' erfc are other
implementations (XLA's and torch's), which agree to about 2e-6 relative
over these arguments (measured); values below 1e-12 are tails no
retry decision reads.  Against the characterization's
``retry.rber_per_retry_step`` (which divides by sqrt(2), takes the
sensing sigma sqrt(sigma^2 + 0) at full tR, and sums the masked
boundaries as a product): rtol 1e-4, atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rber.kernel import rber_pallas
from repro.kernels.rber.ref import PAGE_MASKS as REF_MASKS
from repro.kernels.rber.ref import rber_ref
from repro_torch.core import constants as C
from repro_torch.core import retry as R
from repro_torch.core import voltage as V
from repro_torch.kernels.rber import PAGE_MASKS, rber_fwd, rber_table

RTOL, ATOL = 1e-5, 1e-12
CHAR_RTOL = 1e-4


def _inputs(n_pages, n_steps, seed=0):
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal((n_pages, 8)) * 0.05
          + np.arange(8.0)).astype(np.float32)
    sigma = (0.1 + 0.01 * rng.random((n_pages, 8))).astype(np.float32)
    levels = (np.linspace(0.3, 6.5, 7)[None, :]
              - 0.01 * np.arange(n_steps)[:, None]).astype(np.float32)
    return mu, sigma, levels


@pytest.mark.parametrize("n_pages,n_steps", [(32, 8), (100, 41), (300, 41)])
@pytest.mark.parametrize("against", ["rber_ref", "pallas-interpret"])
def test_plain_matches_reference(n_pages, n_steps, against):
    mu, sigma, levels = _inputs(n_pages, n_steps)
    got = rber_table(mu, sigma, levels, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, n_pages, n_steps)
    args = [jnp.asarray(a) for a in (mu, sigma, levels)]
    want = rber_ref(*args) if against == "rber_ref" else \
        rber_pallas(*args, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_page_masks_are_the_references():
    assert np.array_equal(np.asarray(PAGE_MASKS), np.asarray(REF_MASKS))


def test_matches_characterization_rber():
    """The table of a small stressed population at the 41 retry entries
    equals ``rber_per_retry_step`` (no jitter, tr_scale 1), row by page
    type."""
    rate = torch.from_numpy(np.random.default_rng(4).lognormal(
        0.0, 0.2, (6, 4)).astype(np.float32))
    mu, sigma = V.degraded_distributions(365.0, 1000.0, rate)
    mu, sigma = mu.reshape(-1, 8), sigma.reshape(-1, 8)
    levels = V.retry_read_levels(torch.arange(C.MAX_RETRY_STEPS + 1,
                                              dtype=torch.float32))
    assert levels.shape == (41, 7)
    table = rber_fwd(mu, sigma, levels)
    assert bool((table > 1e-6).any())
    for p, pt in enumerate(C.PAGE_TYPES):
        want = R.rber_per_retry_step(mu, sigma, pt)
        np.testing.assert_allclose(table[p].numpy(), want.numpy(),
                                   rtol=CHAR_RTOL, atol=ATOL)


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\(N, 8\)"):
        rber_fwd(torch.zeros(4, 7), torch.zeros(4, 7), torch.zeros(3, 7))
    with pytest.raises(ValueError, match=r"\(S, 7\)"):
        rber_fwd(torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(3, 8))
