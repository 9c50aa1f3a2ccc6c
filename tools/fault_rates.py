"""Where a fault run's numbers can part between two hosts.

Prints, for one device's characterization of 365 d / 1000 P/E (160
chips), what the fault model derives its rates from and what a fault
run's statistics sum:

  * the host's numpy and torch versions;
  * the final-step ECC margins of the population (a digest of the
    float32 array, its float32 mean as the characterization takes it,
    and its exact mean by ``math.fsum``), and ``mean_margin_final``;
  * ``FaultModel.p_mis`` and ``p_unc`` of ``pr2ar2`` under
    ``FaultConfig()``;
  * the ``websearch`` run of ``pr2ar2`` at 20 000 requests with
    ``FaultConfig()`` (AR²'s reliability guard of ``chip_smoke.py``
    phase 13): its mispredicted reads, a digest of every request's
    completion time, and its read mean by numpy and by ``math.fsum``.

Run it on two hosts and compare the lines:

    PYTHONPATH=src python tools/fault_rates.py cpu
    PYTHONPATH=src python tools/fault_rates.py cuda

The characterization is cached under ``build/fault_rates_cache_<device>``
in the checkout.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(a) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def main(device: str) -> None:
    os.environ["REPRO_TORCH_CHAR_CACHE_DIR"] = str(
        ROOT / "build" / f"fault_rates_cache_{device}")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.core import characterize as CH
    from repro_torch.core import constants as C
    from repro_torch.core import ecc, prng
    from repro_torch.core import retry as R
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim import (FaultConfig, FaultModel,
                                      OperatingCondition, SSDConfig, SSDSim,
                                      resolve_trace)

    ret, pec = 365.0, 1000.0
    print(f"numpy {np.__version__}, torch {torch.__version__}, device "
          f"{device}")
    margins = []
    for i, pt in enumerate(C.PAGE_TYPES):
        key = prng.fold_in(prng.PRNGKey(0, device=device), i)
        rber = CH._population_rber(key, ret, pec, pt, C.N_CHIPS, 8, 16, 1.0,
                                   CH.DEFAULT_NAND)
        k = R.first_success_step(rber)
        final = torch.take_along_dim(rber, k[..., None], dim=-1)[..., 0]
        margins.append(ecc.capability_margin(final).cpu().numpy().ravel())
    m = np.concatenate(margins)
    print(f"margins: {m.size} float32, digest {_digest(m)}, float32 mean "
          f"{float(m.mean())!r}, exact mean "
          f"{math.fsum(m.astype(np.float64)) / m.size!r}")
    st = CH.characterize_condition(ret, pec, device=device)
    print(f"mean_margin_final {st.mean_margin_final!r}, safe_tr_scale "
          f"{st.safe_tr_scale!r}")

    cond = OperatingCondition(ret, pec)
    cfg = SSDConfig(faults=FaultConfig())
    sim = SSDSim(cfg, cond, RetryPolicy("pr2ar2"), seed=7, device=device)
    fm = FaultModel(cfg.faults, cfg, cond, sim.policy, 7, sim)
    print(f"pr2ar2 p_mis {fm.p_mis(0.0)!r}, p_unc {fm.p_unc(0.0)!r}")
    trace = resolve_trace("websearch", seed=0, n_requests=20000)
    s = sim.run(trace)
    resp = sim.last_req_done_us - trace.arrival_us + cfg.host_overhead_us
    reads = resp[trace.is_read]
    print(f"guard pr2ar2: {s.mispredicted_reads} mispredicted, completion "
          f"digest {_digest(sim.last_req_done_us)}, read mean "
          f"{s.read_mean_us!r} (numpy), "
          f"{math.fsum(reads) / reads.size!r} (exact), {reads.size} reads")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
