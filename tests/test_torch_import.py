"""The torch port stands alone: no JAX, no reference package, no silent CPU.

``repro_torch`` must import, simulate and serve on a machine without JAX, must
not import the reference package (not even its numpy-only modules), and
its entry points must run on the CUDA card unless told otherwise —
``device=None`` without CUDA raises instead of falling back.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)",
                        re.MULTILINE)


def test_import_and_simulate_without_jax(tmp_path):
    # A small population characterizes on the CPU; the simulation reads
    # a one-line table (every read succeeds at its third attempt).
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "from repro_torch import (OperatingCondition, characterize_condition,"
        " load_tables, simulate)\n"
        "st = characterize_condition(30.0, 0.0, n_chips=2, device='cpu')\n"
        "h = np.zeros(42); h[3] = 1.0\n"
        "load_tables({(30.0, 0.0): st}, {(30.0, 0.0, pt, False, s): h "
        "for pt in ('lsb', 'csb', 'msb') for s in (1.0, st.safe_tr_scale)})\n"
        "s = simulate('websearch', OperatingCondition(30.0, 0.0), 'pr2ar2',"
        " n_requests=200, engine='batched', device='cpu')\n"
        "assert s.n_requests == 200 and s.fast_path_events > 0, s\n"
        "assert s.mean_read_attempts == 3.0, s\n"
        "from repro_torch.flashsim import run_sweep, sweep_to_json\n"
        "r = simulate('websearch', OperatingCondition(30.0, 0.0), 'pr2ar2',"
        " n_requests=200, engine='reference', device='cpu')\n"
        "assert r.mean_read_attempts == 3.0, r\n"
        "from repro_torch.flashsim import GCConfig, SSDConfig\n"
        "g = simulate('prn', OperatingCondition(30.0, 0.0), 'pr2ar2',"
        " n_requests=1200, seed=1, gc='prepass', cfg=SSDConfig(gc=GCConfig("
        "pec_per_erase=0.0)), device='cpu')\n"
        "assert g.gc_invocations == g.blocks_erased > 0 and g.wa > 1.0, g\n"
        "from repro_torch.flashsim import HostCacheConfig, hostcache\n"
        "assert hostcache.WriteCache(HostCacheConfig()).pending_pages == 0\n"
        "c = simulate('prn', OperatingCondition(30.0, 0.0), 'pr2ar2',"
        " n_requests=1200, seed=1, gc='prepass', ncq_depth=8,"
        " host_cache=HostCacheConfig(),"
        " cfg=SSDConfig(gc=GCConfig(pec_per_erase=0.0)), device='cpu')\n"
        "assert 1 <= c.max_inflight <= 8 and c.cache_absorbed_writes > 0, c\n"
        "assert c.gc_invocations == g.gc_invocations, c\n"
        "from repro_torch.flashsim import FaultConfig\n"
        "o = simulate('prn', OperatingCondition(30.0, 0.0), 'pr2ar2',"
        " n_requests=1200, seed=1, gc='online', engine='auto',"
        " faults=FaultConfig(uncorrectable_prob=0.3, escalation_attempts=1),"
        " cfg=SSDConfig(gc=GCConfig(pec_per_erase=0.0)), device='cpu')\n"
        "assert o.gc_invocations > 0 and o.parity_rebuilds > 0, o\n"
        "assert o.engine_selected == 'array' and o.engine_fallback_reason, o\n"
        "j = sys.argv[1] + '/sweep.jsonl'\n"
        "kw = dict(n_requests=100, device='cpu', journal=j)\n"
        "a = run_sweep('websearch', [OperatingCondition(30.0, 0.0)],"
        " ('baseline',), (0, 1), **kw)\n"
        "assert sweep_to_json(a) == sweep_to_json(run_sweep('websearch',"
        " [OperatingCondition(30.0, 0.0)], ('baseline',), (0, 1), **kw))\n"
        "assert sys.modules['jax'] is None\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "from repro_torch import ServeEngine, get_config\n"
        "from repro_torch.configs import reduced_config\n"
        "eng = ServeEngine(reduced_config(get_config('llama3.2-3b')),"
        " device='cpu')\n"
        "gen, st = eng.generate([np.array([5, 9, 11]), np.array([7, 3])],"
        " max_new_tokens=2)\n"
        "assert gen.shape == (2, 2) and st.kv.pages > 0, (gen, st)\n"
        "eng = ServeEngine(reduced_config(get_config('mamba2-130m')),"
        " device='cpu')\n"
        "gen, st = eng.generate([np.array([5, 9, 11]), np.array([7, 3])],"
        " max_new_tokens=2)\n"
        "assert gen.shape == (2, 2) and st.kv.pages == 0, (gen, st)\n"
        "from repro_torch.models import encdec\n"
        "for arch in ('whisper-large-v3', 'internvl2-1b'):\n"
        "    eng = ServeEngine(reduced_config(get_config(arch)), device='cpu')\n"
        "    gen, st = eng.generate([np.array([5, 9, 11]), np.array([7, 3])],"
        " max_new_tokens=2)\n"
        "    assert gen.shape == (2, 2) and st.kv.pages > 0, (arch, gen, st)\n"
        "from repro_torch.kernels.rber import rber_table\n"
        "t = rber_table(np.zeros((2, 8)), np.ones((2, 8)), np.zeros((3, 7)),"
        " device='cpu')\n"
        "assert t.shape == (3, 2, 3), t.shape\n"
        "import torch\n"
        "from repro_torch.core import calibrate, xla_math\n"
        "assert xla_math.log1p32(torch.zeros(3)).eq(0).all()\n"
        "from repro_torch.checkpoint import CheckpointManager, restore, save\n"
        "from repro_torch.data import FlashTierReader, PrefetchPipeline\n"
        "from repro_torch.optim import AdamWConfig, adamw_update\n"
        "from repro_torch.launch import train as TL\n"
        "cfg = reduced_config(get_config('llama3.2-3b'))\n"
        "st = TL.make_state(cfg, 'cpu')\n"
        "b = {'tokens': torch.ones(1, 8, dtype=torch.int32),"
        " 'labels': torch.ones(1, 8, dtype=torch.int32)}\n"
        "loss = TL.train_step(TL.build_model(cfg, 'cpu').train_loss, st, b,"
        " AdamWConfig())\n"
        "assert torch.isfinite(loss), loss\n"
        "d = save(sys.argv[1] + '/ck', st)\n"
        "r, rs = restore(d)\n"
        "assert rs.n_shards >= 1 and int(r['opt']['step']) == 1, rs\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok', s.mean_us)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_CHAR_CACHE="0",
               REPRO_TORCH_CHAR_CACHE_DIR=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


def test_dryrun_imports_without_jax(tmp_path):
    """The dry-run (``launch.dryrun``, ``launch.cost``, ``launch.fake_cuda``)
    imports and counts a product with JAX blocked, and loads neither JAX
    nor the reference package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch.launch import cost, dryrun, fake_cuda\n"
        "c = cost.analyze(torch.matmul, torch.ones(4, 8), torch.ones(8, 2))\n"
        "assert c.flops == 2 * 4 * 8 * 2, c\n"
        "assert dryrun.variant_flags('kvint8+ep') == {'kvint8', 'ep'}\n"
        "rec = dryrun.run_cell('gemma2-2b', 'long_500k', 'multi', "
        "sys.argv[1])\n"
        "assert rec['status'] == 'skipped', rec\n"
        "assert sys.modules['jax'] is None\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_reference_imports():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    offenders = {}
    for f in files:
        hits = _IMPORT_RE.findall(f.read_text())
        if hits:
            offenders[str(f.relative_to(SRC))] = hits
    assert not offenders, offenders


def _ops_table():
    ops = np.full((2, 16, 7), np.inf)
    ops[:, :, 1] = 3.0
    ops[:, :, 2] = 0.0
    ops[:, :, 6] = 0.0
    ops[0, 0] = [1.0, 0.0, 0.0, 0.0, 2.0, 10.0, 1.0]
    return ops


def _entry_points():
    import repro_torch as rt
    from repro_torch.flashsim import (Cell, OperatingCondition, run_cells,
                                      run_sweep)
    from repro_torch.flashsim.engine_ref import SSDSimRef

    cond = OperatingCondition(30.0, 0.0)
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.kv_retry import kv_read_with_retry
    from repro_torch.kernels.rber import rber_table
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.core import calibrate
    from repro_torch.core import constants as C
    from repro_torch.data import CorpusConfig, FlashTierReader, SyntheticCorpus
    from repro_torch.launch import train as TL
    from repro_torch.models.convert import params_from_jax

    cfg = reduced_config(rt.get_config("llama3.2-3b"))
    mamba = reduced_config(rt.get_config("mamba2-130m"))
    whisper = reduced_config(rt.get_config("whisper-large-v3"))
    from repro_torch.models.api import frontend_zeros
    x = torch.zeros(8, 16)
    q = torch.zeros(1, 8, 2, 2, 16)
    kv = torch.zeros(1, 8, 2, 16)
    return {
        "ServeEngine": lambda: rt.ServeEngine(cfg),
        "build_model": lambda: rt.build_model(cfg),
        "build_model-mamba2": lambda: rt.build_model(mamba),
        "build_model-whisper": lambda: rt.build_model(whisper),
        "frontend_zeros": lambda: frontend_zeros(whisper, 1),
        "ssd_scan": lambda: ssd_scan(torch.zeros(1, 8, 2, 16),
                                     torch.zeros(1, 8, 4),
                                     torch.zeros(1, 8, 4),
                                     torch.ones(1, 8, 2), -torch.ones(2)),
        "rber_table": lambda: rber_table(torch.zeros(2, 8), torch.ones(2, 8),
                                         torch.zeros(3, 7)),
        "params_from_jax": lambda: params_from_jax({"w": np.zeros(3)}),
        "kv_read_with_retry": lambda: kv_read_with_retry(
            x.to(torch.int8), torch.ones(8, 1), x),
        "flash_attention": lambda: flash_attention(q, kv, kv),
        "characterize_condition": lambda: rt.characterize_condition(
            30.0, 0.0, n_chips=2),
        "attempt_histogram": lambda: rt.attempt_histogram(30.0, 0.0),
        "attempt_cdf": lambda: rt.attempt_cdf(30.0, 0.0),
        "SSDSim": lambda: rt.SSDSim(condition=cond),
        "simulate": lambda: rt.simulate("websearch", cond, "baseline",
                                        n_requests=50),
        "simulate-closed": lambda: rt.simulate(
            "websearch", cond, "baseline", n_requests=50, ncq_depth=8),
        "compare_mechanisms": lambda: rt.compare_mechanisms(
            "websearch", cond, n_requests=50),
        "simulate_batch": lambda: rt.simulate_batch(
            "websearch", [cond], n_requests=50),
        "SSDSimRef": lambda: SSDSimRef(condition=cond),
        "run_sweep": lambda: run_sweep("websearch", [cond], ("baseline",),
                                       (0,), n_requests=50),
        "run_cells": lambda: run_cells([Cell(
            "simulate", "websearch", (cond,), ("baseline",), 0,
            n_requests=50)]),
        "fcfs_core": lambda: rt.fcfs_core(_ops_table(), 2, False, 3.0, 5.0),
        "calibrate.evaluate": lambda: calibrate.evaluate(C.DEFAULT_NAND),
        "FlashTierReader": lambda: FlashTierReader(SyntheticCorpus(
            CorpusConfig(vocab=64, seq_len=8, batch=1))),
        "train": lambda: TL.train(cfg, steps=1, batch=1, seq=8),
        "fused_core": lambda: rt.fused_core(
            _ops_table(), 2, False, np.tile([[3.0, 5.0, 0.0]], (2, 1)),
            prio=False),
    }


@pytest.mark.parametrize("name", [
    "ServeEngine", "build_model", "build_model-mamba2", "build_model-whisper",
    "frontend_zeros", "params_from_jax",
    "kv_read_with_retry", "flash_attention", "ssd_scan", "rber_table",
    "characterize_condition", "attempt_histogram", "attempt_cdf", "SSDSim",
    "simulate", "simulate-closed", "compare_mechanisms", "simulate_batch", "SSDSimRef",
    "run_sweep", "run_cells", "fcfs_core", "fused_core",
    "calibrate.evaluate", "FlashTierReader", "train",
])
def test_entry_point_without_cuda_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_CHAR_CACHE", "0")
    from repro_torch.core import characterize as TC

    TC.clear_tables()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
