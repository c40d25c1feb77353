"""The port's ``Checkpointer`` against the JAX package's, on the CPU.

* The reference's cases, mirrored: roundtrip with metadata, async writes
  and GC, a stale ``.tmp`` never shadowing a published step, a corrupt
  blob raising ``TornCheckpointError`` ("checksum"), ``restore_latest``
  skipping torn steps and returning None when none is left, and a
  missing blob refused with ``verify=False``.
* Restore onto a named device from a shape-only (meta) template.
* Across the packages: the reference writes and the port restores, the
  port writes and the reference restores, leaf for leaf equal (bit for
  bit), a bfloat16 leaf included; the leaves' paths are JAX's
  (``params/blocks/l0/mix/wq``, ``opt/count``).
* The async snapshot is a copy: an in-place update made while the
  background write waits does not reach the checkpoint.
"""

import os
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.train.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint as ckmod
from repro_torch.train.checkpoint import Checkpointer, TornCheckpointError


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _bits(x):
    """Raw bytes of a leaf (numpy, JAX or torch; bfloat16 as words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(7, tree, metadata={"step": 7, "note": "x"})
    assert ck.latest_step() == 7
    out, meta = ck.restore(7, {"a": torch.zeros(3, 4),
                               "b": {"c": torch.zeros(5), "d": 0.0}})
    assert meta["note"] == "x"
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save_async(s, {"x": torch.full((4,), float(s))})
    ck.wait()
    assert ck.all_steps() == [3, 4]      # GC kept the last two
    out, _ = ck.restore(4, {"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.full((4,), 4.0))


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir never shadows a published checkpoint."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(3)})
    os.makedirs(os.path.join(str(tmp_path), "step_2.tmp"))  # crashed write
    assert ck.latest_step() == 1


def test_checkpoint_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(128)})
    blob = os.path.join(str(tmp_path), "step_1", "leaf_0.npy")
    arr = np.load(blob)
    arr[0] = 99.0
    np.save(blob, arr)
    with pytest.raises(IOError, match="checksum"):
        ck.restore(1, {"x": torch.zeros(128)})


def test_torn_checkpoint_skip_and_restore(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32),
            "b": np.ones(3, dtype=np.float32)}
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, tree, metadata={"step": 1})
    ck.save(2, {"w": tree["w"] * 2, "b": tree["b"] * 2},
            metadata={"step": 2})
    leaf = os.path.join(str(tmp_path), "step_2", "leaf_0.npy")
    np.save(leaf, np.load(leaf) + 1.0)
    with pytest.raises(TornCheckpointError):
        ck.restore(2, tree)
    with pytest.warns(UserWarning, match="torn checkpoint"):
        restored, meta, step = ck.restore_latest(tree)
    assert step == 1 and meta["step"] == 1
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])
    with open(os.path.join(str(tmp_path), "step_1",
                           "manifest.msgpack"), "wb") as f:
        f.write(b"\xc1garbage")
    with pytest.warns(UserWarning, match="torn checkpoint"):
        assert ck.restore_latest(tree) is None
    os.remove(leaf)
    with pytest.raises(TornCheckpointError):
        ck.restore(2, tree, verify=False)


def test_restore_onto_a_named_device_from_a_meta_template(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": torch.arange(16.0).reshape(4, 4)})
    tpl = {"w": torch.empty(4, 4, device="meta")}
    out, _ = ck.restore(3, tpl, device="cpu")
    assert out["w"].device == torch.device("cpu")
    assert torch.equal(out["w"], torch.arange(16.0).reshape(4, 4))
    out, _ = ck.restore(3, tpl)           # a meta template: the CPU
    assert out["w"].device == torch.device("cpu")


def _mixed_tree_np(rng):
    """A parameter / optimizer tree like a training job's: float32
    matrices, an int32 count, a bfloat16 leaf (as numpy float32 values
    exactly representable in bfloat16)."""
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    return {"params": {"blocks": {"l0": {"mix": {
                "wq": rng.standard_normal((2, 4, 3)).astype(np.float32)}}},
                       "embed": rng.standard_normal((8, 4)).astype(
                           np.float32),
                       "bf": bf},
            "opt": {"count": np.int32(7),
                    "mu": {"x": rng.standard_normal(6).astype(np.float32)}}}


def _as_jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x, jnp.bfloat16)
        if path[-1].key == "bf" else jnp.asarray(x), tree)


def _as_torch(tree):
    return {k: _as_torch(v) if isinstance(v, dict) else
            params_from_jax({"a": np.asarray(v)})["a"]
            for k, v in tree.items()}


def test_reference_writes_port_restores(tmp_path):
    jtree = _as_jax(_mixed_tree_np(np.random.default_rng(0)))
    RefCheckpointer(str(tmp_path)).save(4, jtree, metadata={"step": 4})
    with open(tmp_path / "step_4" / "manifest.msgpack", "rb") as f:
        manifest = msgpack.unpackb(f.read())
    paths = [e["path"] for e in manifest["leaves"]]
    assert "params/blocks/l0/mix/wq" in paths and "opt/count" in paths
    assert paths == ckmod.flatten_with_paths(_as_torch(jtree))[0]
    out, meta = Checkpointer(str(tmp_path)).restore(4, _as_torch(jtree))
    assert meta == {"step": 4}
    assert out["params"]["bf"].dtype == torch.bfloat16
    assert out["opt"]["count"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves(jtree), _leaves(out)):
        assert _bits(np.asarray(a)) == _bits(b)


def test_port_writes_reference_restores(tmp_path):
    jtree = _as_jax(_mixed_tree_np(np.random.default_rng(1)))
    ttree = _as_torch(jtree)
    Checkpointer(str(tmp_path)).save(9, ttree, metadata={"step": 9})
    out, meta = RefCheckpointer(str(tmp_path)).restore(
        9, jax.tree.map(jnp.zeros_like, jtree))
    assert meta == {"step": 9}
    with open(tmp_path / "step_9" / "manifest.msgpack", "rb") as f:
        dtypes = {e["path"]: e["dtype"]
                  for e in msgpack.unpackb(f.read())["leaves"]}
    assert dtypes["params/bf"] == "bfloat16"
    assert dtypes["opt/count"] == "int32"
    for a, b in zip(_leaves(ttree), jax.tree.leaves(out)):
        assert _bits(a) == _bits(np.asarray(b))
    # and the port reads back what it wrote, bfloat16 as bfloat16
    back, _ = Checkpointer(str(tmp_path)).restore(9, ttree)
    for a, b in zip(_leaves(ttree), _leaves(back)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_async_snapshot_survives_an_in_place_update(tmp_path, monkeypatch):
    """The background write is held until the tensors have been changed
    in place (what the optimizer does to the weights while a checkpoint
    is written): the checkpoint holds the values at save_async."""
    release = threading.Event()
    write = Checkpointer._write

    def held_write(self, *args):
        assert release.wait(timeout=30)
        return write(self, *args)

    monkeypatch.setattr(Checkpointer, "_write", held_write)
    ck = Checkpointer(str(tmp_path))
    w = torch.arange(1000.0)
    b = torch.ones(3, dtype=torch.bfloat16)
    ck.save_async(1, {"w": w, "b": b})
    w.mul_(-1.0)
    b.add_(1.0)
    release.set()
    ck.wait()
    out, _ = ck.restore(1, {"w": w, "b": b})
    assert torch.equal(out["w"], torch.arange(1000.0))
    assert torch.equal(out["b"], torch.ones(3, dtype=torch.bfloat16))
