"""Device fault model and controller recovery ladder for flashsim.

The reference package's fault model, kept here as the port's own copy
(numpy and the standard library, with the port's characterization and
ECC model): the same draws from the same substreams, so a run with
faults equals the reference's given the same characterization tables.
Without it every read succeeds within its sampled attempt count, and
AR²'s "does not sacrifice reliability" claim is a best-case one: the
latency cost of the reliability guard (a reduced-tR read whose RBER
exceeds the shaved ECC margin must re-read at nominal tR) is never
charged.  This module models the recovery ladder real controllers run
(Cai et al.'s error survey; Luo's reliability-architecture work):

  1. **retry escalation** — an uncorrectable final retry step triggers up
     to ``FaultConfig.escalation_attempts`` full-strength re-reads at
     nominal tR (serial, die held throughout);
  2. **superpage-parity rebuild** — if escalation fails, the page is
     reconstructed from its superpage stripe peers: *real* read page-ops
     on the other dies of the channel, carrying the original request id,
     contending on the die queues like GC traffic;
  3. **bad-block retirement** — the failing block is retired
     (:meth:`repro_torch.flashsim.ftl.PageMapFTL.retire_block`): valid pages
     relocate through the GC frontier and the block never returns to the
     free pool;
  4. a rebuild whose peer reads also fail counts as **unrecoverable**
     (data loss) — ~impossible at paper-default ECC margins.

AR² mispredictions ride the same machinery as a 1-step ladder: the
reduced-tR read's decode fails against the shaved margin and one extra
*nominal*-tR attempt is charged before the data returns.

Determinism contract
--------------------
All draws come from per-die RNG substreams seeded
``(run seed, FaultConfig.salt, die)`` and are consumed in die-local
event order, which is shard-invariant (the same argument that makes the
online-GC attempt streams shard-exact — see
:mod:`repro_torch.flashsim.gc_online`).  The fault streams are *separate* from
the attempt-sampling streams, so enabling faults never changes which
retry-attempt counts a run draws, and ``faults=None`` runs are
bit-identical to a build without this module.

Three execution paths
---------------------
* **in-place / prepass** runs plan faults in a deterministic pre-pass
  (:func:`plan_faults`) over the admission stream: extra recovery
  attempts land in the per-op ``xa``/``xtr`` buffers the engine converts
  into serial nominal-tR continuations, and rebuild peer reads /
  retirement relocation ops are *inserted* into the admission stream at
  the trigger op's arrival — the same approximation the prepass FTL
  documents for GC traffic.  Retirement here charges relocation traffic
  (``pages_per_block // 2`` page copies) without touching the
  pre-computed mapping; exact FTL retirement is online-mode only.
* **online GC** draws at the simulated instants
  (:class:`repro_torch.flashsim.gc_online.OnlineGC` hooks): wear-resolved
  probabilities per block, real :meth:`~repro_torch.flashsim.ftl.PageMapFTL.
  retire_block` relocation, erase failures that drop blocks from the
  pool, and program failures that stretch the op on the die.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core import ecc
from repro_torch.core import characterize as CH
from repro_torch.flashsim.config import FaultConfig, OperatingCondition, SSDConfig

__all__ = ["FaultModel", "FaultOutcome", "FaultPlan", "plan_faults"]


@dataclasses.dataclass
class FaultOutcome:
    """Mutable per-run recovery counters (one instance per FaultModel)."""

    mispredicted_reads: int = 0   # AR² reduced-tR decode failures
    rescued_reads: int = 0        # uncorrectables saved by escalation
    parity_rebuilds: int = 0      # escalation exhausted -> stripe rebuild
    rebuild_reads: int = 0        # peer read page-ops issued by rebuilds
    retired_blocks: int = 0       # bad blocks retired (rebuild + erase-fail)
    program_fails: int = 0        # host programs that needed a reprogram
    erase_fails: int = 0          # erases that failed verification
    unrecoverable: int = 0        # rebuilds whose peers also failed
    #: Request ids that paid any recovery latency (mispredict, escalation,
    #: rebuild, program retry) — the population of the recovery-p99 tail.
    affected_rids: Set[int] = dataclasses.field(default_factory=set)


class FaultModel:
    """Seeded, deterministic fault draws for one simulation run.

    Construct once per :meth:`repro_torch.flashsim.ssd.SSDSim.run` call; the
    per-die streams make draw order die-local, so the monolithic and
    per-channel-sharded engines consume identical streams.
    """

    def __init__(
        self,
        fc: FaultConfig,
        cfg: SSDConfig,
        condition: OperatingCondition,
        policy,
        seed: int,
        sim,
    ):
        self.fc = fc
        self.cfg = cfg
        self.cond = condition
        self.policy = policy
        self.sim = sim
        self.rngs = [
            np.random.default_rng((seed, fc.salt, d))
            for d in range(cfg.n_dies)
        ]
        self._mult = {int(d): float(m) for d, m in fc.failslow_dies}
        self._p_unc: Dict[float, float] = {}
        self._p_mis: Dict[float, float] = {}
        self.outcome = FaultOutcome()

    # -- probability derivation ---------------------------------------------

    def die_mult(self, die: int) -> float:
        """Fail-slow latency multiplier of a die (1.0 when healthy)."""
        return self._mult.get(die, 1.0)

    @staticmethod
    def _rber_at(margin: float) -> float:
        """Capability margin -> RBER: margin = (t - rber*n)/t."""
        return (1.0 - margin) * ecc.DEFAULT_ECC.rber_cap

    def p_unc(self, wear_pec: float) -> float:
        """Uncorrectable probability of a read's final retry step.

        Derived from :func:`repro_torch.core.ecc.page_fail_probability` at
        the final-step mean margin of the block's wear-resolved condition
        (snapped to the characterization grid, characterized on the run's
        device, memoized per bin as a host float), unless
        ``FaultConfig.uncorrectable_prob`` pins it explicitly.
        """
        key = CH.snap_pec(self.cond.with_wear(wear_pec).pec)
        p = self._p_unc.get(key)
        if p is None:
            fc = self.fc
            if fc.uncorrectable_prob is not None:
                base = fc.uncorrectable_prob
            else:
                st = CH.characterize_condition(
                    self.cond.retention_days, key, device=self.sim.device)
                base = float(ecc.page_fail_probability(
                    self._rber_at(st.mean_margin_final)))
            p = min(1.0, base * fc.uncorrectable_scale)
            self._p_unc[key] = p
        return p

    def p_mis(self, wear_pec: float) -> float:
        """AR² misprediction probability at a block's wear.

        Only adaptive-tR policies sensing below scale 1.0 can mispredict.
        Derivation: the reduced sense leaves a fraction ``scale`` of the
        mean final-step RBER margin, so the shaved-margin RBER is
        ``cap - scale * (cap - rber_mean)``; the misprediction
        probability is the page-failure probability there minus the
        full-strength one (a misprediction is a read the nominal sense
        *would* have decoded — ~1-2% at aged conditions, growing with
        wear).  ``FaultConfig.mispredict_prob`` pins it explicitly.
        """
        if not self.policy.adaptive_tr:
            return 0.0
        scale = self.sim._scale_for(wear_pec)
        if scale >= 1.0:
            return 0.0
        key = CH.snap_pec(self.cond.with_wear(wear_pec).pec)
        p = self._p_mis.get(key)
        if p is None:
            fc = self.fc
            if fc.mispredict_prob is not None:
                base = fc.mispredict_prob
            else:
                st = CH.characterize_condition(
                    self.cond.retention_days, key, device=self.sim.device)
                cap = ecc.DEFAULT_ECC.rber_cap
                rber_full = self._rber_at(st.mean_margin_final)
                rber_red = cap - scale * (cap - rber_full)
                pf_red = float(ecc.page_fail_probability(rber_red))
                pf_full = float(ecc.page_fail_probability(rber_full))
                base = max(0.0, pf_red - pf_full)
            p = min(1.0, base * fc.mispredict_scale)
            self._p_mis[key] = p
        return p

    # -- the recovery ladder -------------------------------------------------

    def read_ladder(self, die: int, wear_pec: float):
        """Draw one host read's failure ladder from ``die``'s substream.

        Returns ``(extra_attempts, rebuild, affected)``:
        ``extra_attempts`` serial nominal-tR re-reads to charge (the
        misprediction re-read and/or escalation attempts), ``rebuild``
        whether escalation exhausted and a parity rebuild must run, and
        ``affected`` whether the request paid any recovery latency.
        """
        fc = self.fc
        rng = self.rngs[die]
        out = self.outcome
        extra = 0
        affected = False
        pm = self.p_mis(wear_pec)
        if pm > 0.0 and rng.random() < pm:
            extra += 1
            out.mispredicted_reads += 1
            affected = True
        pu = self.p_unc(wear_pec)
        rebuild = False
        if pu > 0.0 and rng.random() < pu:
            affected = True
            rescued = False
            for _ in range(fc.escalation_attempts):
                extra += 1
                if rng.random() >= pu:
                    rescued = True
                    break
            if rescued:
                out.rescued_reads += 1
            elif fc.parity_rebuild:
                rebuild = True
            else:
                out.unrecoverable += 1
        return extra, rebuild, affected

    def rebuild_peers(self, die: int) -> List[int]:
        """Superpage stripe peers: the other dies of ``die``'s channel."""
        c = die % self.cfg.n_channels
        return [d for d in range(c, self.cfg.n_dies, self.cfg.n_channels)
                if d != die]

    def rebuild_outcome(self, die: int, n_peers: int) -> bool:
        """Account one parity rebuild; draw per-peer uncorrectables.

        Returns True when the rebuild itself failed (any stripe peer
        uncorrectable at device-baseline wear -> data loss).
        """
        out = self.outcome
        out.parity_rebuilds += 1
        out.rebuild_reads += n_peers
        pu = self.p_unc(0.0)
        failed = False
        if pu > 0.0:
            rng = self.rngs[die]
            for _ in range(n_peers):
                if rng.random() < pu:
                    failed = True
        if failed:
            out.unrecoverable += 1
        return failed

    def draw_program_fail(self, die: int) -> bool:
        p = self.fc.program_fail_prob
        return p > 0.0 and self.rngs[die].random() < p

    def draw_erase_fail(self, die: int) -> bool:
        p = self.fc.erase_fail_prob
        return p > 0.0 and self.rngs[die].random() < p


@dataclasses.dataclass
class FaultPlan:
    """Admission stream rewritten by the fault pre-pass (plain lists).

    Same layout :func:`repro_torch.flashsim.engine.make_buffers` takes, plus
    the per-op recovery buffers ``xa`` (extra serial attempts the engine
    appends after the last sampled attempt) and ``xtr`` (their per-
    attempt sense time — nominal tR, fail-slow multiplied).
    """

    arrival: List[float]
    rid: List[int]
    die: List[int]
    ch: List[int]
    read: List[bool]
    erase: List[bool]
    dur: List[float]
    a: List[int]
    tr: List[float]
    xa: List[int]
    xtr: List[float]
    #: Logical page per op (-1 for GC/inserted recovery ops); only present
    #: when the caller passed ``lpn`` — the closed-loop frontend needs it
    #: for write-cache hit detection.
    lpn: Optional[List[int]] = None


def plan_faults(
    model: FaultModel,
    adm: List[float],
    rid: List[int],
    die: List[int],
    ch: List[int],
    read: List[bool],
    erase: List[bool],
    dur: List[float],
    a: List[int],
    tr: List[float],
    ptype: List[int],
    wear: Optional[List[float]],
    lpn: Optional[List[int]] = None,
) -> FaultPlan:
    """Deterministic fault pre-pass over an admission stream.

    Walks the ops in admission order drawing each die's substream in
    die-local order (shard partitioning never reorders a die's ops, so
    the plan is identical however the engine is decomposed — and it runs
    *before* the engine either way).  Host reads run the recovery
    ladder: extra attempts land in ``xa``/``xtr``; a parity rebuild
    inserts its stripe-peer reads (carrying the original request id,
    admitted at the trigger's arrival — the same trigger-time
    approximation the prepass FTL uses for GC traffic) and, with
    ``retire_blocks``, ``pages_per_block // 2`` relocation page-ops on
    the failing die.  Host programs draw program failures (+tPROG);
    erases draw (counted-only — prepass mapping is fixed) erase
    failures.  Fail-slow multipliers stretch sense and hold durations.
    """
    sim = model.sim
    fc = model.fc
    cfg = model.cfg
    out = model.outcome
    tprog = cfg.timing.tprog_us
    n_ch = cfg.n_channels
    n_reloc = cfg.gc.pages_per_block // 2

    o_adm: List[float] = []
    o_rid: List[int] = []
    o_die: List[int] = []
    o_ch: List[int] = []
    o_read: List[bool] = []
    o_erase: List[bool] = []
    o_dur: List[float] = []
    o_a: List[int] = []
    o_tr: List[float] = []
    o_xa: List[int] = []
    o_xtr: List[float] = []
    o_lpn: List[int] = []

    def emit(t, r, d, c, rd, er, du, at, sn, x=0, xt=0.0, lp=-1):
        o_adm.append(t)
        o_rid.append(r)
        o_die.append(d)
        o_ch.append(c)
        o_read.append(rd)
        o_erase.append(er)
        o_dur.append(du)
        o_a.append(at)
        o_tr.append(sn)
        o_xa.append(x)
        o_xtr.append(xt)
        o_lpn.append(lp)

    for i in range(len(adm)):
        d = die[i]
        mult = model.die_mult(d)
        w = float(wear[i]) if wear is not None else 0.0
        r = rid[i]
        lp_i = lpn[i] if lpn is not None else -1
        if read[i]:
            tr_i = tr[i] * mult
            xa_i, xtr_i, rebuild = 0, 0.0, False
            if r >= 0:
                extra, rebuild, affected = model.read_ladder(d, w)
                if extra:
                    xa_i = extra
                    xtr_i = float(sim._tr_base[ptype[i]]) * mult
                if affected:
                    out.affected_rids.add(r)
            emit(adm[i], r, d, ch[i], True, False, dur[i], a[i], tr_i,
                 xa_i, xtr_i, lp_i)
            if rebuild:
                pt = ptype[i]
                peers = model.rebuild_peers(d)
                model.rebuild_outcome(d, len(peers))
                for dd in peers:
                    pm = model.die_mult(dd)
                    pa = sim._draw_attempts(pt, 0.0, rng=model.rngs[d])
                    emit(adm[i], r, dd, dd % n_ch, True, False, 0.0, pa,
                         sim._tr_for(pt, 0.0) * pm)
                if fc.retire_blocks:
                    out.retired_blocks += 1
                    for _ in range(n_reloc):
                        ra = sim._draw_attempts(pt, w, rng=model.rngs[d])
                        emit(adm[i], -1, d, ch[i], True, False, 0.0, ra,
                             sim._tr_for(pt, w) * mult)
                        emit(adm[i], -1, d, ch[i], False, False,
                             tprog * mult, 1, 0.0)
        elif erase[i]:
            if model.draw_erase_fail(d):
                # Prepass mapping is fixed before the run; charge the
                # counter (and the retirement) without rewriting history.
                out.erase_fails += 1
                out.retired_blocks += 1
            emit(adm[i], r, d, ch[i], False, True, dur[i] * mult, a[i],
                 tr[i])
        else:
            dur_i = dur[i] * mult
            if r >= 0 and model.draw_program_fail(d):
                out.program_fails += 1
                out.affected_rids.add(r)
                dur_i += tprog * mult
            emit(adm[i], r, d, ch[i], False, False, dur_i, a[i], tr[i],
                 lp=lp_i)

    return FaultPlan(
        arrival=o_adm, rid=o_rid, die=o_die, ch=o_ch, read=o_read,
        erase=o_erase, dur=o_dur, a=o_a, tr=o_tr, xa=o_xa, xtr=o_xtr,
        lpn=o_lpn if lpn is not None else None,
    )
