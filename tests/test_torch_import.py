"""The torch port stands alone: no JAX, no reference package, no silent CPU.

``repro_torch`` must import and simulate on a machine without JAX, must
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
        "assert sys.modules['jax'] is None\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', s.mean_us)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_CHAR_CACHE="0",
               REPRO_TORCH_CHAR_CACHE_DIR=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


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
    from repro_torch.flashsim import OperatingCondition

    cond = OperatingCondition(30.0, 0.0)
    return {
        "characterize_condition": lambda: rt.characterize_condition(
            30.0, 0.0, n_chips=2),
        "attempt_histogram": lambda: rt.attempt_histogram(30.0, 0.0),
        "attempt_cdf": lambda: rt.attempt_cdf(30.0, 0.0),
        "SSDSim": lambda: rt.SSDSim(condition=cond),
        "simulate": lambda: rt.simulate("websearch", cond, "baseline",
                                        n_requests=50),
        "compare_mechanisms": lambda: rt.compare_mechanisms(
            "websearch", cond, n_requests=50),
        "simulate_batch": lambda: rt.simulate_batch(
            "websearch", [cond], n_requests=50),
        "fcfs_core": lambda: rt.fcfs_core(_ops_table(), 2, False, 3.0, 5.0),
        "fused_core": lambda: rt.fused_core(
            _ops_table(), 2, False, np.tile([[3.0, 5.0, 0.0]], (2, 1)),
            prio=False),
    }


@pytest.mark.parametrize("name", [
    "characterize_condition", "attempt_histogram", "attempt_cdf", "SSDSim",
    "simulate", "compare_mechanisms", "simulate_batch", "fcfs_core",
    "fused_core",
])
def test_entry_point_without_cuda_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_CHAR_CACHE", "0")
    from repro_torch.core import characterize as TC

    TC.clear_tables()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
