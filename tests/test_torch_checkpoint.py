"""The port's checkpoints against the reference's ``repro.checkpoint``.

For the same state the port writes shard and parity files byte-identical
to the reference's (jax's flattening order, greedy 16 MiB shards, CRC32,
XOR parity groups), each package restores the other's checkpoints, and
the reference's ``tests/test_checkpoint.py`` cases hold for the port:
parity reconstruction of one corrupt or lost shard per group, pipelined
and serial restore, the manager's rotation, commit markers and fallback.
"""

import json

import numpy as np
import pytest
import torch

from repro import checkpoint as RCK
from repro_torch.checkpoint import (CheckpointManager, corrupt_shard,
                                    delete_shard, restore, save)
from repro_torch.checkpoint.ckpt import flatten


@pytest.fixture
def tree():
    rng = np.random.default_rng(0)
    return {
        "a": rng.normal(size=(100, 1000)).astype(np.float32),
        "b": {"w": np.ones((333, 77), np.float32), "s": np.int32(7)},
        "c": [rng.normal(size=(512, 256)).astype(np.float32)
              for _ in range(5)],
    }


@pytest.fixture
def ttree(tree):
    """The same state as tensors."""
    return {"a": torch.from_numpy(tree["a"]),
            "b": {"w": torch.from_numpy(tree["b"]["w"]),
                  "s": torch.tensor(7, dtype=torch.int32)},
            "c": [torch.from_numpy(c) for c in tree["c"]]}


def _assert_tree_equal(x, y):
    fx, fy = flatten(x), flatten(y)
    assert [k for k, _ in fx] == [k for k, _ in fy]
    for (_, a), (_, b) in zip(fx, fy):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _files(d):
    return sorted(p.name for p in d.iterdir() if p.suffix == ".bin")


class TestAgainstReference:
    @pytest.mark.parametrize("shard_bytes,group", [(1 << 19, 3), (1 << 24, 4),
                                                   (1 << 18, 2)])
    def test_shard_and_parity_files_byte_identical(self, tmp_path, tree,
                                                   ttree, shard_bytes, group):
        RCK.save(tmp_path / "ref", tree, shard_bytes=shard_bytes,
                 parity_group=group)
        save(tmp_path / "port", ttree, shard_bytes=shard_bytes,
             parity_group=group)
        names = _files(tmp_path / "ref")
        assert names == _files(tmp_path / "port") and names
        for n in names:
            assert (tmp_path / "ref" / n).read_bytes() == \
                (tmp_path / "port" / n).read_bytes(), n
        ref = json.loads((tmp_path / "ref" / "manifest.json").read_text())
        port = json.loads((tmp_path / "port" / "manifest.json").read_text())
        for k in ("leaves", "shards", "parity", "parity_group"):
            assert port[k] == ref[k], k
        assert port["keys"] == [r["key"] for r in ref["leaves"]]

    def test_port_restores_reference_checkpoint(self, tmp_path, tree, ttree):
        d = RCK.save(tmp_path / "ck", tree, shard_bytes=1 << 19,
                     parity_group=3)
        corrupt_shard(d, 2)
        out, st = restore(d, ttree)
        _assert_tree_equal(out, ttree)
        assert st.n_reconstructed == 1

    def test_reference_restores_port_checkpoint(self, tmp_path, tree, ttree):
        d = save(tmp_path / "ck", ttree, shard_bytes=1 << 19, parity_group=3)
        delete_shard(d, 1)
        out, st = RCK.restore(d, tree)
        _assert_tree_equal(out, tree)
        assert st.n_reconstructed == 1

    def test_restore_without_template_from_keys(self, tmp_path, ttree):
        d = save(tmp_path / "ck", {"p": ttree["b"], "q": ttree["a"]})
        out, _ = restore(d)
        _assert_tree_equal(out, {"p": ttree["b"], "q": ttree["a"]})

    def test_tailed_model_state_byte_identical(self, tmp_path):
        """A tailed recurrentgemma's parameters (stacked units plus the
        tail's plain list, from the reference's init through
        ``params_from_jax``): the same leaf order as jax's and
        byte-identical files, restored bit for bit."""
        import dataclasses

        import jax

        from repro.configs import get_config as ref_get_config
        from repro.configs.base import reduced_config as ref_reduced_config
        from repro.models import build_model as ref_build_model
        from repro_torch.models.convert import params_from_jax
        from repro_torch.optim.adamw import tree_leaves

        rcfg = dataclasses.replace(ref_reduced_config(
            ref_get_config("recurrentgemma-2b")), n_layers=8)
        params = jax.tree.map(np.asarray, ref_build_model(rcfg).init(
            jax.random.PRNGKey(0)))
        tparams = params_from_jax(params, "cpu")
        assert isinstance(tparams["tail"], list) and len(tparams["tail"]) == 2
        for a, b in zip(jax.tree.leaves(params), tree_leaves(tparams),
                        strict=True):
            np.testing.assert_array_equal(a, b.numpy())
        RCK.save(tmp_path / "ref", params, shard_bytes=1 << 18)
        d = save(tmp_path / "port", tparams, shard_bytes=1 << 18)
        names = _files(tmp_path / "ref")
        assert names == _files(d) and names
        for n in names:
            assert (tmp_path / "ref" / n).read_bytes() == (d / n).read_bytes()
        out, _ = restore(d, tparams)
        _assert_tree_equal(out, tparams)

    def test_encdec_state_byte_identical_and_restored_by_both(self,
                                                              tmp_path):
        """A reduced whisper's parameters (the learned positions, stacked
        encoder and decoder units with their cross sub-blocks): the same
        leaf order as jax's, byte-identical files, and each package
        restores the other's checkpoint bit for bit, one corrupt shard
        reconstructed."""
        import jax

        from repro.configs import get_config as ref_get_config
        from repro.configs.base import reduced_config as ref_reduced_config
        from repro.models import build_model as ref_build_model
        from repro_torch.models.convert import params_from_jax
        from repro_torch.optim.adamw import tree_leaves

        rcfg = ref_reduced_config(ref_get_config("whisper-large-v3"))
        params = jax.tree.map(np.asarray, ref_build_model(rcfg).init(
            jax.random.PRNGKey(0)))
        tparams = params_from_jax(params, "cpu")
        assert "xattn" in tparams["dec_units"]["b0"]
        for a, b in zip(jax.tree.leaves(params), tree_leaves(tparams),
                        strict=True):
            np.testing.assert_array_equal(a, b.numpy())
        ref_d = RCK.save(tmp_path / "ref", params, shard_bytes=1 << 20)
        d = save(tmp_path / "port", tparams, shard_bytes=1 << 20)
        names = _files(ref_d)
        assert names == _files(d) and len(names) > 2
        for n in names:
            assert (ref_d / n).read_bytes() == (d / n).read_bytes(), n
        corrupt_shard(ref_d, 1)
        out, st = restore(ref_d, tparams)
        _assert_tree_equal(out, tparams)
        assert st.n_reconstructed == 1
        delete_shard(d, 0)
        out, st = RCK.restore(d, params)
        _assert_tree_equal(out, params)
        assert st.n_reconstructed == 1

    def test_bfloat16_leaves_round_trip(self, tmp_path):
        x = torch.randn(64, 33).to(torch.bfloat16)
        out, _ = restore(save(tmp_path / "ck", {"x": x}), {"x": x})
        assert out["x"].dtype == torch.bfloat16
        assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))


class TestSaveRestore:
    @pytest.mark.parametrize("pipelined", [True, False])
    def test_roundtrip(self, tmp_path, ttree, pipelined):
        save(tmp_path / "ck", ttree, shard_bytes=1 << 19, parity_group=3)
        out, st = restore(tmp_path / "ck", ttree, pipelined=pipelined)
        _assert_tree_equal(out, ttree)
        assert st.n_reconstructed == 0 and st.n_failed == 0
        assert st.pipelined == pipelined and st.n_shards > 1

    def test_single_corruption_per_group_recovers(self, tmp_path, ttree):
        d = save(tmp_path / "ck", ttree, shard_bytes=1 << 19, parity_group=3)
        corrupt_shard(d, 1)
        out, st = restore(d, ttree)
        _assert_tree_equal(out, ttree)
        assert st.n_reconstructed == 1

    def test_lost_shard_recovers(self, tmp_path, ttree):
        d = save(tmp_path / "ck", ttree, shard_bytes=1 << 19, parity_group=3)
        delete_shard(d, 4)
        out, st = restore(d, ttree)
        _assert_tree_equal(out, ttree)
        assert st.n_reconstructed == 1

    def test_two_failures_one_group_raises(self, tmp_path, ttree):
        d = save(tmp_path / "ck", ttree, shard_bytes=1 << 19, parity_group=3)
        corrupt_shard(d, 0)
        corrupt_shard(d, 1)  # same parity group of 3
        with pytest.raises(IOError):
            restore(d, ttree)

    def test_failures_in_different_groups_recover(self, tmp_path, ttree):
        d = save(tmp_path / "ck", ttree, shard_bytes=1 << 19, parity_group=2)
        corrupt_shard(d, 0)
        delete_shard(d, 3)  # group 1 (shards 2, 3)
        out, st = restore(d, ttree)
        _assert_tree_equal(out, ttree)
        assert st.n_reconstructed == 2


class TestManager:
    def test_rotation_and_fallback(self, tmp_path, ttree):
        mgr = CheckpointManager(tmp_path, keep=2, save_every=10,
                                parity_group=3, shard_bytes=1 << 19)
        for s in (10, 20, 30):
            mgr.save(s, ttree)
        assert mgr.steps() == [20, 30]
        corrupt_shard(mgr._dir(30), 0)
        corrupt_shard(mgr._dir(30), 1)
        step, out, _ = mgr.restore_latest(ttree)
        assert step == 20
        _assert_tree_equal(out, ttree)

    def test_uncommitted_checkpoint_invisible(self, tmp_path, ttree):
        mgr = CheckpointManager(tmp_path, keep=3, save_every=10)
        mgr.save(10, ttree)
        d = mgr.save(20, ttree)
        (d / "COMMITTED").unlink()  # simulate crash mid-save
        assert mgr.steps() == [10]
        step, _, _ = mgr.restore_latest(ttree)
        assert step == 10

    def test_should_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path, save_every=50)
        assert mgr.should_save(50) and mgr.should_save(100)
        assert not mgr.should_save(0) and not mgr.should_save(51)
