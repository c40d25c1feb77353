"""Async checkpointing: the counterpart of ``repro.train.checkpoint``,
with its on-disk format, so a checkpoint written by either package
restores in the other.

  * A checkpoint is a directory ``step_<n>/`` holding one ``.npy`` blob
    per leaf of a nested dict (``leaf_<i>.npy``, leaves in JAX's order:
    dict keys sorted) plus a msgpack ``manifest.msgpack`` naming each
    leaf by its path (keys joined with ``/``, e.g.
    ``params/blocks/l0/mix/wq``, ``opt/count``) with its file, shape,
    dtype and crc32, and the user metadata.
  * Writes go to ``step_<n>.tmp/`` and are published by an atomic
    ``os.rename``; a crash mid-write never shadows the latest complete
    checkpoint. ``keep`` bounds how many are kept.
  * ``save_async`` copies the tree to host memory synchronously and
    writes in a background thread. The copy is what lets training go on:
    the optimizer updates the weights in place while the thread writes.
  * bfloat16 leaves are written as raw 16-bit words (numpy's ``V2``, as
    ``np.save`` of the reference's ``ml_dtypes.bfloat16`` arrays writes
    them) with manifest dtype ``"bfloat16"``, and read back through the
    manifest's dtype: no ``ml_dtypes`` is needed.
  * ``restore(step, template, device=)`` places the leaves on the target
    device; with ``layout=`` and ``specs=`` (a ``launch.mesh.Layout``
    with a ``DeviceMesh`` and the leaves' specs) each leaf is read on the
    host and placed with the target layout's placements: the elastic
    reshard of the reference's ``restore(mesh=, specs=)``.
  * A tree of DTensors (a model on a mesh) is saved by gathering each
    leaf once (``full_tensor``, on every rank); rank 0 writes the same
    format, and the other ranks wait for it (a barrier after the write)
    before they go on.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import Device
from repro_torch.models.common import AxisSizes, is_dtensor

__all__ = ["Checkpointer", "TornCheckpointError", "flatten_with_paths"]

PyTree = Any
_STEP_RE = re.compile(r"^step_(\d+)$")
BF16 = "bfloat16"


class TornCheckpointError(IOError):
    """A checkpoint directory is incomplete or corrupt — torn by a crash
    mid-write, partial storage loss, or bit rot (CRC mismatch).
    ``restore`` raises this instead of the raw IO/parse error so callers
    can tell "this step is damaged, try an older one"
    (:meth:`Checkpointer.restore_latest`) apart from programming errors
    like restoring into a template of the wrong structure."""


def flatten_with_paths(tree: PyTree) -> Tuple[List[str], List]:
    """``(paths, leaves)`` of a nested dict in JAX's order (keys sorted),
    each path its keys joined with ``/``."""
    if not isinstance(tree, dict):
        return [""], [tree]
    paths, leaves = [], []
    for key in sorted(tree):
        sub_paths, sub_leaves = flatten_with_paths(tree[key])
        paths += [f"{key}/{p}" if p else str(key) for p in sub_paths]
        leaves += sub_leaves
    return paths, leaves


def _unflatten_like(tree: PyTree, leaves: List) -> PyTree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def _host_copy(x) -> np.ndarray:
    """A host numpy copy of a leaf that shares no memory with it
    (bfloat16 as its 16-bit words, numpy dtype ``V2``)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(x, copy=True)


def _dtype_name(arr: np.ndarray) -> str:
    return BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")          # a copy, 0-d kept 0-d
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False     # the last save was of a sharded tree

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: PyTree,
             metadata: Optional[Dict] = None) -> str:
        self.wait()
        host, writer = self._snapshot(tree)
        final = os.path.join(self.directory, f"step_{step}")
        if writer:
            final = self._write(step, host, metadata or {})
        self.wait()
        return final

    def save_async(self, step: int, tree: PyTree,
                   metadata: Optional[Dict] = None) -> None:
        """Snapshot synchronously, write in the background."""
        self.wait()
        host, writer = self._snapshot(tree)
        meta = dict(metadata or {})

        def work():
            try:
                self._write(step, host, meta)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if writer:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            # A sharded save: every rank waits for rank 0's write.
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _snapshot(self, tree: PyTree):
        """``((paths, host arrays), writer)``: DTensor leaves are
        gathered whole (a collective every rank takes part in), and only
        rank 0 writes them."""
        paths, leaves = flatten_with_paths(tree)
        sharded = any(is_dtensor(x) for x in leaves)
        host = [_host_copy(x.full_tensor() if is_dtensor(x) else x)
                for x in leaves]
        self._barrier = sharded
        return (paths, host), not sharded or dist.get_rank() == 0

    def _write(self, step: int, host, metadata: Dict) -> str:
        paths, arrays = host
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "metadata": metadata, "leaves": []}
        for i, (path, arr) in enumerate(zip(paths, arrays)):
            fname = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "path": path, "file": fname, "shape": list(arr.shape),
                "dtype": _dtype_name(arr),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(msgpack.packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)      # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.msgpack")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: PyTree, device: Device = None,
                verify: bool = True, layout=None,
                specs: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
        """Restore into the structure of ``template``: each leaf a tensor
        of the checkpoint's dtype and shape on ``device`` (by default the
        template leaf's device, the layout's, or the CPU). With
        ``layout`` (a ``launch.mesh.Layout`` with a ``DeviceMesh``) and
        ``specs`` (a spec per leaf, the tree's structure), each leaf
        becomes a DTensor with the spec's placements on the layout's
        mesh, each rank keeping its shard. A torn directory —
        unreadable/unparsable manifest, missing leaf blob or manifest
        entry, checksum mismatch — raises :class:`TornCheckpointError`."""
        d = os.path.join(self.directory, f"step_{step}")
        try:
            with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
                manifest = msgpack.unpackb(f.read())
        except (OSError, msgpack.UnpackException, ValueError) as e:
            raise TornCheckpointError(
                f"step {step}: unreadable manifest ({e})") from e
        by_path = {e["path"]: e for e in manifest["leaves"]}
        paths, leaves = flatten_with_paths(template)
        spec_leaves = None
        if layout is not None and specs is not None:
            spec_leaves = flatten_with_paths(specs)[1]
            ax = AxisSizes.from_mesh(layout)
            device = device if device is not None else layout.device
        out = []
        for i, (path, tmpl) in enumerate(zip(paths, leaves)):
            entry = by_path.get(path)
            if entry is None:
                raise TornCheckpointError(
                    f"step {step}: leaf {path!r} missing from manifest")
            try:
                arr = np.load(os.path.join(d, entry["file"]))
            except (OSError, ValueError) as e:
                raise TornCheckpointError(
                    f"step {step}: unreadable leaf {path!r} ({e})") from e
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != entry["crc32"]:
                    raise TornCheckpointError(
                        f"step {step}: checksum mismatch for {path}")
            where = device if device is not None else (
                tmpl.device if isinstance(tmpl, torch.Tensor) and
                tmpl.device.type != "meta" else "cpu")
            leaf = _to_tensor(arr, entry["dtype"], where)
            if spec_leaves is not None:
                from torch.distributed.tensor import distribute_tensor
                leaf = distribute_tensor(
                    leaf, ax.mesh, ax.placements(spec_leaves[i]),
                    src_data_rank=None)
            out.append(leaf)
        return _unflatten_like(template, out), manifest["metadata"]

    def restore_latest(self, template: PyTree, device: Device = None,
                       verify: bool = True
                       ) -> Optional[Tuple[PyTree, Dict, int]]:
        """Restore the newest *intact* checkpoint: torn steps are
        reported via ``warnings.warn`` and skipped, walking backwards
        until one verifies. Returns ``(tree, metadata, step)``, or
        ``None`` when no restorable checkpoint exists."""
        for step in reversed(self.all_steps()):
            try:
                tree, meta = self.restore(step, template, device=device,
                                          verify=verify)
                return tree, meta, step
            except TornCheckpointError as e:
                # stacklevel=2: attribute the skip to restore_latest's
                # caller, not this loop body.
                warnings.warn(f"skipping torn checkpoint: {e}",
                              stacklevel=2)
        return None
