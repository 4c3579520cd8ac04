"""Fault-tolerant checkpointing (the JAX package's ``ckpt/manager.py`` in
PyTorch), in the reference's format, so that a checkpoint written by either
package restores in the other.

* Atomic: write to ``step_N.tmp/`` then fsync + rename; a crash mid-save
  never corrupts the latest checkpoint.
* Integrity: per-leaf SHA1 in ``manifest.json``; restore verifies.
* Format: one ``leaf_%05d.bin`` of raw bytes a leaf, in the JAX flatten
  order (dict keys sorted, tuples and named tuples in field order), the
  manifest giving each leaf's shape, dtype string (``bfloat16`` leaves are
  their 2-byte words) and sha1.
* Async: ``save(..., background=True)`` copies the leaves to host memory
  and writes on a worker thread -- the train loop is blocked only for the
  device-to-host copy.  The copy is a copy on every device: the next
  step's in-place update cannot reach the snapshot.

Leaves are tensors (any device) or numpy arrays.  ``restore`` rebuilds
``template``'s structure with CPU tensors, or on ``device``.  Restoring
onto a mesh (the reference's ``shardings``) is the multi-card layer,
ROADMAP.md Queue 1 item 14.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from .. import device as _device

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.bfloat16: "bfloat16", torch.float16: "float16",
           torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
           torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _DTYPES.items()}


def tree_flatten(tree: Any) -> List[Any]:
    """The leaves in the JAX flatten order: dict values by sorted key,
    tuples (named ones too) and lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_flatten(t)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with ``leaves`` in the flatten order."""
    n = len(tree_flatten(template))
    if n != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a template of {n}")
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _snapshot(leaf):
    """A host copy of one leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _raw(leaf) -> tuple:
    """(raw bytes, shape, dtype string) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        dtype = _DTYPES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), list(t.shape), dtype
    a = np.asarray(leaf)
    return np.ascontiguousarray(a).tobytes(), list(a.shape), str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        return max(steps) if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, background: bool = False) -> None:
        self.wait()  # never two writers (same-step final + async save race)
        host = [_snapshot(a) for a in tree_flatten(tree)]  # D2H snapshot
        if background:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves: List[Any]) -> None:
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(leaves),
                    "treedef": f"{len(leaves)} leaves in the JAX flatten "
                               f"order", "leaves": []}
        for i, leaf in enumerate(leaves):
            path = os.path.join(tmp, f"leaf_{i:05d}.bin")
            raw, shape, dtype = _raw(leaf)
            with open(path, "wb") as f:
                f.write(raw)
            manifest["leaves"].append(
                {"i": i, "shape": shape, "dtype": dtype,
                 "sha1": hashlib.sha1(raw).hexdigest()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        all_steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                           if d.startswith("step_")
                           and not d.endswith(".tmp"))
        for s in all_steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Any:
        """Restore into ``template``'s structure: CPU tensors, or tensors
        on ``device``.  ``shardings`` (the reference's elastic restore onto
        a mesh) raises ``NotImplementedError``."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto a mesh (shardings=) is the multi-card "
                "layer: ROADMAP.md Queue 1 item 14")
        dev = None if device is None else _device.resolve(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for meta in manifest["leaves"]:
            path = os.path.join(d, f"leaf_{meta['i']:05d}.bin")
            with open(path, "rb") as f:
                raw = f.read()
            if hashlib.sha1(raw).hexdigest() != meta["sha1"]:
                raise IOError(f"checksum mismatch in {path}")
            dtype = _TORCH[meta["dtype"]]
            t = (torch.frombuffer(bytearray(raw), dtype=dtype) if raw
                 else torch.empty(0, dtype=dtype)).reshape(meta["shape"])
            leaves.append(t if dev is None else t.to(dev))
        return tree_unflatten(template, leaves)
