"""Sharded, atomic, async checkpointing with deterministic resume.

The port of ``repro/train/checkpoint.py``, with the same layout on disk
(per step):

    <dir>/step_<N>.tmp/            — written first
        MANIFEST.json              — leaf names, shapes, dtypes, step,
                                     data-pipeline state, process count
        proc00000/leaf_<k>.npy     — this process's copy of leaf k
    <dir>/step_<N>/                — atomic rename on completion

Trees are the port's nested dicts and lists of tensors (or numpy
arrays), their leaves named and ordered as the reference names and
orders a pytree's (:mod:`repro_torch.train.tree`). One process writes
everything (this slice runs on one device). bfloat16 leaves are stored
as their raw 16-bit words with the logical dtype recorded, as the
reference stores them, so either package reads the other's files.
``AsyncCheckpointer`` copies to the host on the caller's thread and
serializes on a background thread; ``keep`` bounds retention. Restores
place each leaf on the device and in the dtype of the matching leaf of
``like``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import Tree, named_leaves, tree_map

PROCESS_INDEX = 0
PROCESS_COUNT = 1


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(numpy array to store, logical dtype name) of one leaf; bf16 as
    its raw uint16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Tree,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Synchronous save of every leaf; returns the final checkpoint
    path. A re-save of an existing step leaves the first one."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    shard_dir = os.path.join(tmp, f"proc{PROCESS_INDEX:05d}")
    os.makedirs(shard_dir, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "process_count": PROCESS_COUNT, "format_version": 1}
    for i, (name, leaf) in enumerate(named_leaves(tree)):
        arr, logical_dtype = _host_array(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(shard_dir, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": logical_dtype})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):            # re-save of the same step
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)           # atomic commit
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest committed checkpoint in ``directory``, or
    None."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def _tensor(arr: np.ndarray, logical_dtype: str,
            like: Any) -> torch.Tensor:
    """A stored array as a tensor on ``like``'s device (and in its dtype
    when ``like`` is a tensor)."""
    if logical_dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore_checkpoint(path: str, like: Tree
                       ) -> Tuple[Tree, int, Dict[str, Any]]:
    """Restore into the structure of ``like``: (tree, step, extra). Each
    leaf lands on the device of ``like``'s leaf of the same name; a
    missing leaf or a shape mismatch raises."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    shard_dir = os.path.join(path, f"proc{PROCESS_INDEX:05d}")
    by_name = {e["name"]: e for e in manifest["leaves"]}
    restored: List[torch.Tensor] = []
    for name, leaf in named_leaves(like):
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(shard_dir, entry["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        restored.append(_tensor(arr, entry["dtype"], leaf))
    it = iter(restored)
    tree = tree_map(lambda _: next(it), like)
    return tree, manifest["step"], manifest.get("extra", {})


class AsyncCheckpointer:
    """Snapshot to the host on the caller's thread (a copy: the trainer
    updates its tensors in place), serialize on a background thread;
    ``wait()`` joins the save in flight. A crash between saves loses at
    most one interval: the .tmp/rename protocol never exposes a torn
    checkpoint."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = []

    def save(self, step: int, tree: Tree,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Wait for the previous save, copy ``tree`` to the host, and
        write it in the background."""
        self.wait()
        host_tree = tree_map(lambda x: _host_array(x)[0].copy()
                             if not isinstance(x, torch.Tensor)
                             else x.detach().to("cpu", copy=True), tree)

        def run():
            try:
                save_checkpoint(self.directory, step, host_tree, extra,
                                self.keep)
                self.saved_steps.append(step)
            except BaseException as exc:   # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
