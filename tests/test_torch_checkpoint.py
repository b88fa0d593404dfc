"""The port's CheckpointManager: the contract of
``tests/test_checkpoint.py`` and ``test_substrate.py::TestCheckpoint``
(round trip, keep-N, invisible partial checkpoints, failed saves leave no
temporary directory, corrupt arrays raise), and the on-disk format it
shares with the reference's manager: a checkpoint written by either
restores in the port with bfloat16 leaves bit-identical, and one written
by the port restores in the reference's manager.  The reference hands a
bfloat16 leaf back as the 2-byte void dtype ``|V2`` that ``np.savez``
wrote (ROADMAP Queue C); the port reads it as bfloat16.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.bridge import to_tensor
from repro_torch.checkpoint.manager import (CheckpointManager, _flatten,
                                            _unflatten)


def _tree(step):
    return {"params": {"w": torch.full((2, 3), float(step)),
                       "b": torch.arange(3.0),
                       "e": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16)},
            "step": torch.tensor(step, dtype=torch.int32),
            "nested": [torch.ones((1,)), torch.zeros((2,))]}


def _bf16_bits(t):
    return t.view(torch.uint16).numpy()


class TestRoundTrip:
    def test_save_restore_tree_and_metadata(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3)
        mgr.save(5, _tree(5), metadata={"note": "hello", "knobs": {"a": 1}})
        tree, meta = mgr.restore(5)
        want = _tree(5)
        assert torch.equal(tree["params"]["w"], want["params"]["w"])
        assert tree["params"]["e"].dtype == torch.bfloat16
        assert torch.equal(tree["params"]["e"], want["params"]["e"])
        assert tree["step"].dtype == torch.int32 and int(tree["step"]) == 5
        # list nodes come back as string-keyed dicts, as in the reference
        assert torch.equal(tree["nested"]["0"], torch.ones((1,)))
        assert meta == {"note": "hello", "knobs": {"a": 1}, "step": 5}

    def test_flatten_unflatten_inverse(self):
        tree = {"a": {"b": 1, "c/with/slashes": 2}, "d": 3}
        assert _unflatten(_flatten(tree)) == tree

    def test_restore_latest_picks_newest_onto_a_device(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        for s in (1, 3, 2):
            mgr.save(s, _tree(s))
        tree, meta = mgr.restore_latest(device="cpu")
        assert meta["step"] == 3
        assert torch.equal(tree["params"]["w"], torch.full((2, 3), 3.0))
        assert tree["params"]["w"].device.type == "cpu"


class TestErrorPaths:
    def test_restore_latest_empty_dir(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore_latest() == (None, None)
        assert mgr.list_steps() == []

    def test_partial_checkpoint_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, _tree(1))
        partial = tmp_path / "ckpt_0000000002"
        partial.mkdir()
        np.savez(partial / "arrays.npz", x=np.ones(3))
        assert mgr.list_steps() == [1]
        _, meta = mgr.restore_latest()
        assert meta["step"] == 1

    def test_corrupt_arrays_raise(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        path = mgr.save(1, _tree(1))
        with open(os.path.join(path, "arrays.npz"), "wb") as f:
            f.write(b"not an npz")
        with pytest.raises(Exception):
            mgr.restore(1)

    def test_failed_save_leaves_no_temp_dirs(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(TypeError):
            mgr.save(1, _tree(1), metadata={"bad": object()})
        assert os.listdir(tmp_path) == []
        assert mgr.list_steps() == []


class TestKeepN:
    def test_gc_keeps_newest_n(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in range(1, 5):
            mgr.save(s, _tree(s))
        assert mgr.list_steps() == [3, 4]
        assert sorted(os.listdir(tmp_path)) == ["ckpt_0000000003",
                                                "ckpt_0000000004"]

    def test_keep_zero_disables_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=0)
        for s in range(1, 4):
            mgr.save(s, _tree(s))
        assert mgr.list_steps() == [1, 2, 3]


def _jax_tree():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    return {"params": {"smollm/embed": {"table": jnp.asarray(w, jnp.bfloat16)},
                       "scale": jnp.asarray(w[0])},
            "opt": {"step": jnp.asarray(7, jnp.int32)}}


class TestCrossPackage:
    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        """bf16 leaves come back as bfloat16 with the reference's bits."""
        want = _jax_tree()
        JaxManager(str(tmp_path)).save(3, want, {"note": "jax"})
        tree, meta = CheckpointManager(str(tmp_path)).restore_latest()
        assert meta == {"note": "jax", "step": 3}
        table = tree["params"]["smollm/embed"]["table"]
        assert table.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bf16_bits(table),
            _bf16_bits(to_tensor(np.asarray(
                want["params"]["smollm/embed"]["table"]))))
        np.testing.assert_array_equal(tree["params"]["scale"].numpy(),
                                      np.asarray(want["params"]["scale"]))
        assert tree["opt"]["step"].dtype == torch.int32
        assert int(tree["opt"]["step"]) == 7

    def test_port_checkpoint_restores_in_the_reference(self, tmp_path):
        """The port writes the reference's bytes: the JAX manager reads
        the same tree, the bf16 leaf as |V2 holding its bits."""
        tree = _tree(4)
        CheckpointManager(str(tmp_path)).save(4, tree)
        got, meta = JaxManager(str(tmp_path)).restore_latest()
        assert meta["step"] == 4
        np.testing.assert_array_equal(got["params"]["w"],
                                      tree["params"]["w"].numpy())
        e = got["params"]["e"]
        assert e.dtype == np.dtype("V2")
        np.testing.assert_array_equal(e.view(np.uint16),
                                      _bf16_bits(tree["params"]["e"]))
        np.testing.assert_array_equal(got["nested"]["1"], np.zeros((2,)))

    def test_reference_restores_bf16_as_void(self, tmp_path):
        """Pins the reference's own behaviour: its restore hands a bfloat16
        leaf back as ``|V2``, which JAX rejects, so the reference cannot
        resume bf16 params from its own checkpoint."""
        JaxManager(str(tmp_path)).save(1, _jax_tree())
        got, _ = JaxManager(str(tmp_path)).restore_latest()
        leaf = got["params"]["smollm/embed"]["table"]
        assert leaf.dtype == np.dtype("V2")
        with pytest.raises(TypeError, match="V2"):
            jnp.asarray(leaf)
