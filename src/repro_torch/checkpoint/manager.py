"""Checkpointing: atomic npz shards + manifest, async writes, verified restore.

The port of the JAX package's ``repro/checkpoint/manager.py``, with the
same on-disk layout (one directory per step):

    ckpt_dir/step_00000100/
        manifest.json     # step, leaves (shape, dtype, hash, key), extra
        shard_h0.npz      # the leaves, full logical arrays
        COMMITTED         # sentinel written last (atomic-rename discipline)

A tree is nested dicts (or lists) of tensors or arrays; a leaf's name is
its path of keys joined with ``/`` (dict keys sorted), so a tree of
``{"params": dict(model.named_parameters())}`` stores each parameter
under ``params/<its dotted name>``.

  * writes go to ``step_X.tmp`` then ``os.rename``: a crash mid-write
    never corrupts the latest checkpoint;
  * an async writer thread overlaps serialization with training compute;
    ``wait()`` is called before the next save or at exit;
  * ``restore`` verifies each leaf's SHA-256 and shape, and puts each
    tensor on its target's device in its target's dtype;
  * ``keep_n`` garbage-collects old steps, never the newest committed one.

bfloat16 leaves are stored as their raw 16-bit words with the dtype
``bfloat16`` in the manifest (numpy has no bfloat16), so their hashes
are those of the same values written by the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _named_leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(name, leaf)`` in flatten order: dict keys sorted, list indices."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named_leaves(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _named_leaves(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree: Tree, values: Iterator[Any]) -> Tree:
    """``tree``'s structure with its leaves replaced, in flatten order."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], values) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, values) for sub in tree)
    return next(values)


def _to_host(leaf: Any) -> Any:
    """A host copy of a leaf (tensors to the CPU, detached)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _from_stored(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_tree(tree: Tree, directory: str, step: int, extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save of a tree. Returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in _named_leaves(tree):
        arr, dtype = _to_numpy(leaf)
        key = name.replace("/", "__")
        arrays[key] = arr
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": dtype,
            "sha": _sha(arr),
            "key": key,
        }
    np.savez(os.path.join(tmp, "shard_h0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_tree(
    directory: str,
    target: Tree,
    step: Optional[int] = None,
    verify: bool = True,
) -> Tuple[Tree, int, Dict]:
    """Restore into the structure of ``target``, whose leaves are tensors:
    each restored leaf takes its target's shape (checked), dtype and
    device.  Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_h0.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    leaves = []
    for name, tgt in _named_leaves(target):
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"leaf {name} missing from checkpoint")
        arr = arrays[meta["key"]]
        if verify and _sha(arr) != meta["sha"]:
            raise IOError(f"hash mismatch for {name}")
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs target {tuple(tgt.shape)}"
            )
        leaves.append(_from_stored(arr, meta["dtype"]).to(device=tgt.device, dtype=tgt.dtype))
    return _rebuild(target, iter(leaves)), step, manifest["extra"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "COMMITTED")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


class CheckpointManager:
    """Async keep-N checkpoint manager."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, tree: Tree, step: int, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        # copied to the host on the caller's thread: the training step
        # updates the tensors in place right after
        host_tree = _rebuild(tree, (_to_host(leaf) for _, leaf in _named_leaves(tree)))

        def work():
            try:
                save_tree(host_tree, self.directory, step, extra)
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        if blocking:
            work()
            if self._error:
                err, self._error = self._error, None
                raise err
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, target: Tree, step: Optional[int] = None):
        return restore_tree(self.directory, target, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, d, "COMMITTED"))
        )
        for s in steps[: -self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
