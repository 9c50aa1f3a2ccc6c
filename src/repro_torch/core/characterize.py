"""160-chip characterization harness — the paper's §3 observations, in torch.

Runs the population characterization on a torch device (the CUDA card
by default): per operating condition, the retry-step statistics, the
ECC-capability margin at the success entry, the AR² safe-tR scale, and
the per-page-type attempt histograms the simulator samples from.  The
draws come from :mod:`repro_torch.core.prng`, key for key the reference's
``jax.random`` draws, so the port characterizes the same population.

Results are memoized in-process (keyed without the device: the same
population on any device) and persisted on disk under
``~/.cache/repro_torch`` (relocate with ``REPRO_TORCH_CHAR_CACHE_DIR``;
``REPRO_CHAR_CACHE=0`` disables), a directory of its own so the port's
entries never mix with the reference's.  :func:`load_tables` places an
externally computed characterization in the in-process memo — the seam
through which tests give the port and the reference identical tables.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import ecc as ecc_mod
from repro_torch.core import prng
from repro_torch.core import retry as R
from repro_torch.core import timing as T
from repro_torch.core import voltage as V
from repro_torch.core.constants import NandParams, DEFAULT_NAND
from repro_torch.device import resolve_device

#: Operating-condition grid used throughout (days, P/E cycles).
RETENTION_GRID_DAYS = (0.0, 7.0, 30.0, 90.0, 180.0, 365.0)
PEC_GRID = (0.0, 500.0, 1000.0, 1500.0)

#: Candidate tR scales for the AR² search (1.0 = full sensing time).
TR_SCALE_GRID = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.6)

#: AR² acceptance: the expected attempt count with reduced tR may exceed
#: the full-tR expectation by at most this many attempts.
EXTRA_ATTEMPT_BUDGET = 0.30

#: Never sense faster than this regardless of margin (circuit floor).
TR_SCALE_FLOOR = 0.7


# -- on-disk characterization cache ----------------------------------------

#: Version 2: the float32 math is XLA's (``core/xla_math.py``), so tables
#: of version 1 (torch's transcendentals) differ in their ulps and must
#: never be served.
_CHAR_CACHE_VERSION = 2


def _char_cache_dir() -> Optional[str]:
    if os.environ.get("REPRO_CHAR_CACHE", "1") == "0":
        return None
    return os.environ.get("REPRO_TORCH_CHAR_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch"
    )


def _char_cache_path(kind: str, ext: str, **kw) -> Optional[str]:
    d = _char_cache_dir()
    if d is None:
        return None
    blob = repr((_CHAR_CACHE_VERSION, kind, sorted(kw.items())))
    h = hashlib.sha1(blob.encode()).hexdigest()[:24]
    return os.path.join(d, f"{kind}_{h}.{ext}")


def _char_cache_load(path: Optional[str]):
    if path is None or not os.path.exists(path):
        return None
    try:
        if path.endswith(".npy"):
            return np.load(path)
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # corrupt/partial entry: fall through to recompute


def _char_cache_store(path: Optional[str], value) -> None:
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        if path.endswith(".npy"):
            with open(tmp, "wb") as f:
                np.save(f, value)
        else:
            with open(tmp, "w") as f:
                json.dump(value, f)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort; never fail the computation


@dataclasses.dataclass(frozen=True)
class ConditionStats:
    retention_days: float
    pec: float
    mean_retry_steps: float        # attempts - 1, averaged over population
    p99_retry_steps: float
    frac_reads_with_retry: float   # P[attempts > 1]
    mean_margin_final: float       # ECC-capability margin at success entry
    p01_margin_final: float        # 1st-percentile margin (worst pages)
    safe_tr_scale: float           # AR² table entry


# In-process memos (what the reference keeps in lru_caches), keyed by
# every argument except the device.
_COND_MEMO: Dict[tuple, ConditionStats] = {}
_HIST_MEMO: Dict[tuple, np.ndarray] = {}
_CDF_MEMO: Dict[tuple, np.ndarray] = {}


def clear_tables() -> None:
    """Drop every memoized characterization (the disk cache stays)."""
    _COND_MEMO.clear()
    _HIST_MEMO.clear()
    _CDF_MEMO.clear()


def tables_snapshot() -> tuple:
    """Copies of the three in-process memos, for :func:`restore_tables`
    in another process (the sweep runtime hands them to spawned
    workers, which start with empty memos)."""
    return dict(_COND_MEMO), dict(_HIST_MEMO), dict(_CDF_MEMO)


def restore_tables(snapshot: tuple) -> None:
    """Place a :func:`tables_snapshot` in this process's memos, every
    array read-only as the memos hand them out."""
    for memo, tables in zip((_COND_MEMO, _HIST_MEMO, _CDF_MEMO), snapshot):
        for key, value in tables.items():
            if isinstance(value, np.ndarray):
                value.setflags(write=False)
            memo[key] = value


def _cond_key(retention_days, pec, n_chips=C.N_CHIPS, n_blocks=8,
              n_pages=16, seed=0, params=DEFAULT_NAND):
    return (float(retention_days), float(pec), n_chips, n_blocks, n_pages,
            seed, params)


def _hist_key(retention_days, pec, page_type="csb", sota=False,
              tr_scale=1.0, seed=0, max_attempts=C.MAX_RETRY_STEPS + 1):
    return (float(retention_days), float(pec), page_type, bool(sota),
            float(tr_scale), seed, max_attempts)


def load_tables(stats: Mapping, hists: Mapping) -> None:
    """Place an externally computed characterization in the memo.

    ``stats`` maps ``(retention_days, pec)`` to a condition record (any
    dataclass or mapping with :class:`ConditionStats`' fields);
    ``hists`` maps ``(retention_days, pec, page_type, sota, tr_scale)``
    to an attempt histogram (numpy, index = attempts).  Both land under
    the default population arguments — exactly the lookups
    :class:`repro_torch.flashsim.ssd.SSDSim` makes — so a simulation
    afterwards reads these tables instead of characterizing.
    """
    for (r, p), rec in stats.items():
        d = dataclasses.asdict(rec) if dataclasses.is_dataclass(rec) \
            else dict(rec)
        _COND_MEMO[_cond_key(r, p)] = ConditionStats(**d)
    for (r, p, pt, sota, s), h in hists.items():
        key = _hist_key(r, p, pt, sota, s)
        h = np.array(h, dtype=np.float64)
        h.setflags(write=False)
        _HIST_MEMO[key] = h
        _CDF_MEMO.pop(key, None)


def mean32(counts: torch.Tensor) -> float:
    """float32 mean of integer counts as ``jnp.mean`` gives it on XLA's
    CPU backend: the exact sum (below 2^24) times the float32 reciprocal
    of the count, on the host for every device."""
    inv = np.float32(1.0) / np.float32(counts.numel())
    return float(np.float32(int(counts.sum())) * inv)


def _population_rber(key, retention_days, pec, page_type, n_chips, n_blocks,
                     n_pages, tr_scale, params) -> torch.Tensor:
    """(chips, blocks, pages, steps) RBER tensor for one page type."""
    k_var, k_jit = prng.split(key)
    rate = V.sample_process_variation(k_var, n_chips, n_blocks, params)
    mu, sigma = V.degraded_distributions(retention_days, pec, rate, params)
    jitter = C.PAGE_JITTER_SIGMA * prng.normal(
        k_jit, (n_chips, n_blocks, n_pages, 7))
    return R.rber_per_retry_step(
        mu[..., None, :], sigma[..., None, :], page_type,
        tr_scale, level_jitter=jitter, params=params)


def characterize_condition(retention_days: float, pec: float,
                           n_chips: int = C.N_CHIPS, n_blocks: int = 8,
                           n_pages: int = 16, seed: int = 0,
                           params: NandParams = DEFAULT_NAND,
                           device=None) -> ConditionStats:
    """Full characterization of one operating condition (memoized)."""
    dev = resolve_device(device)
    memo_key = _cond_key(retention_days, pec, n_chips, n_blocks, n_pages,
                         seed, params)
    hit = _COND_MEMO.get(memo_key)
    if hit is not None:
        return hit
    cache_path = _char_cache_path(
        "cond", "json",
        retention_days=retention_days, pec=pec, n_chips=n_chips,
        n_blocks=n_blocks, n_pages=n_pages, seed=seed, params=repr(params),
        ecc=repr(ecc_mod.DEFAULT_ECC),
    )
    cached = _char_cache_load(cache_path)
    if cached is not None:
        try:
            stats = ConditionStats(**cached)
            _COND_MEMO[memo_key] = stats
            return stats
        except TypeError:
            pass  # entry from an older ConditionStats schema: recompute
    steps_all, margins_all = [], []
    safe_scales = []
    for i, pt in enumerate(C.PAGE_TYPES):
        key = prng.fold_in(prng.PRNGKey(seed, device=dev), i)
        rber = _population_rber(key, retention_days, pec, pt, n_chips,
                                n_blocks, n_pages, 1.0, params)
        k = R.first_success_step(rber)                       # (C, B, P)
        rber_final = torch.take_along_dim(rber, k[..., None], dim=-1)[..., 0]
        margin = ecc_mod.capability_margin(rber_final)
        steps_all.append(k.cpu().numpy())
        margins_all.append(margin.cpu().numpy())

        # AR² search: re-run the whole retry search at each candidate
        # scale; a scale is admissible if the expected attempt count
        # stays within EXTRA_ATTEMPT_BUDGET of full-tR, and the
        # admissible scale of least expected pipelined latency wins.
        mean_attempts_1 = mean32(k + 1)
        best_s, best_lat = 1.0, None
        for s in TR_SCALE_GRID:
            if s < TR_SCALE_FLOOR:
                break
            rber_s = _population_rber(key, retention_days, pec, pt, n_chips,
                                      n_blocks, n_pages, float(s), params)
            k_s = R.first_success_step(rber_s,
                                       max_steps=params.max_retry_steps)
            mean_attempts_s = mean32(k_s + 1)
            if mean_attempts_s > mean_attempts_1 + EXTRA_ATTEMPT_BUDGET:
                continue
            lat = float(np.mean(T.pipelined_read_latency(
                (k_s + 1).cpu().numpy(), page_type=pt, tr_scale=float(s))))
            if best_lat is None or lat < best_lat:
                best_s, best_lat = float(s), lat
        safe_scales.append(best_s)

    steps = np.concatenate([s.ravel() for s in steps_all])
    margins = np.concatenate([m.ravel() for m in margins_all])
    stats = ConditionStats(
        retention_days=retention_days,
        pec=pec,
        mean_retry_steps=float(steps.mean()),
        p99_retry_steps=float(np.percentile(steps, 99)),
        frac_reads_with_retry=float((steps > 0).mean()),
        mean_margin_final=float(margins.mean()),
        p01_margin_final=float(np.percentile(margins, 1)),
        safe_tr_scale=float(max(safe_scales)),  # safe for ALL page types
    )
    _char_cache_store(cache_path, dataclasses.asdict(stats))
    _COND_MEMO[memo_key] = stats
    return stats


def safe_tr_table(retentions: Tuple[float, ...] = RETENTION_GRID_DAYS,
                  pecs: Tuple[float, ...] = PEC_GRID, seed: int = 0,
                  device=None) -> Dict[Tuple[float, float], float]:
    """AR²'s condition -> best-safe-tR-scale lookup table."""
    return {
        (r, p): characterize_condition(r, p, seed=seed,
                                       device=device).safe_tr_scale
        for r in retentions
        for p in pecs
    }


def snap_pec(pec: float) -> float:
    """Snap a continuous P/E count *up* to the characterization grid."""
    for p in PEC_GRID:
        if p >= pec:
            return float(p)
    return float(PEC_GRID[-1])


def lookup_tr_scale(retention_days: float, pec: float, device=None) -> float:
    """AR² table lookup with conservative (next-worse-bin) snapping."""
    r_candidates = [r for r in RETENTION_GRID_DAYS if r >= retention_days]
    r_bin = r_candidates[0] if r_candidates else RETENTION_GRID_DAYS[-1]
    return characterize_condition(r_bin, snap_pec(pec),
                                  device=device).safe_tr_scale


def attempt_histogram(retention_days: float, pec: float,
                      page_type: str = "csb", sota: bool = False,
                      tr_scale: float = 1.0, seed: int = 0,
                      max_attempts: int = C.MAX_RETRY_STEPS + 1,
                      device=None) -> np.ndarray:
    """Empirical attempt-count distribution for one page type (memoized,
    read-only), shape ``(max_attempts + 1,)``; index = attempts.

    ``tr_scale`` < 1 models AR²: the whole retry search runs at reduced
    sensing time, so the extra attempts it induces are captured.
    """
    dev = resolve_device(device)
    memo_key = _hist_key(retention_days, pec, page_type, sota, tr_scale,
                         seed, max_attempts)
    hit = _HIST_MEMO.get(memo_key)
    if hit is not None:
        return hit
    cache_path = _char_cache_path(
        "hist", "npy",
        retention_days=retention_days, pec=pec, page_type=page_type,
        sota=sota, tr_scale=tr_scale, seed=seed, max_attempts=max_attempts,
        params=repr(DEFAULT_NAND), ecc_cap=C.ECC_RBER_CAP,
    )
    hist = _char_cache_load(cache_path)
    if hist is None or hist.shape != (max_attempts + 1,):
        key = prng.fold_in(prng.PRNGKey(seed + 101, device=dev),
                           C.PAGE_TYPES.index(page_type))
        attempts, _ = R.attempts_for_population(
            key, retention_days, pec, page_type, sota=sota,
            tr_scale=tr_scale)
        a = attempts.cpu().numpy().ravel()
        counts = np.bincount(
            np.clip(a, 0, max_attempts), minlength=max_attempts + 1
        ).astype(np.float64)
        hist = counts / counts.sum()
        _char_cache_store(cache_path, hist)
    hist.setflags(write=False)
    _HIST_MEMO[memo_key] = hist
    return hist


def attempt_cdf(retention_days: float, pec: float, page_type: str = "csb",
                sota: bool = False, tr_scale: float = 1.0, seed: int = 0,
                max_attempts: int = C.MAX_RETRY_STEPS + 1,
                device=None) -> np.ndarray:
    """Cumulative form of :func:`attempt_histogram` (memoized, read-only);
    the simulator inverse-CDF-samples attempt counts from it."""
    memo_key = _hist_key(retention_days, pec, page_type, sota, tr_scale,
                         seed, max_attempts)
    cdf = _CDF_MEMO.get(memo_key)
    if cdf is None:
        cdf = np.cumsum(attempt_histogram(
            retention_days, pec, page_type=page_type, sota=sota,
            tr_scale=tr_scale, seed=seed, max_attempts=max_attempts,
            device=device))
        cdf.setflags(write=False)
        _CDF_MEMO[memo_key] = cdf
    else:
        resolve_device(device)
    return cdf
