"""Checkpointing in the reference's on-disk layout: leaf files, async save,
atomic commit.

The counterpart of ``repro.training.checkpoint``::

    <dir>/ckpt_<step>.tmp/      # written first
        manifest.json           # tree description, shapes/dtypes, step, extras
        leaf<i>.s<k>.npy        # leaf i's k-th shard (split on axis 0)
    <dir>/ckpt_<step>/          # atomic rename once every file is fsynced
        COMMIT                  # marker: readers trust committed dirs only

Trees hold tensors; leaves are numbered in ``jax.tree``'s order
(:mod:`repro_torch.tree`). Each shard is stored as raw bytes in a uint8
``.npy``, as the reference stores it; a bf16 leaf goes through a
``uint16`` view (numpy has no bfloat16), bit for bit. The snapshot to host
memory is taken on the caller's thread, the file writes on a background
thread; ``wait()`` joins it. An interrupted save leaves only a ``.tmp``
directory, which :func:`latest_step` ignores and ``clean()`` removes.
Restore places every leaf on the device and in the dtype of the matching
leaf of the tree it is given; with sharding rules on a rank grid it
returns the rank's slice of each leaf of a checkpoint written whole (the
reference's re-mesh restore, ``shardings=``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

__all__ = ["Checkpointer", "save_checkpoint", "load_checkpoint",
           "latest_step"]

_NUMPY_OF = {torch.bfloat16: np.uint16}


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf's host copy as numpy (bf16 as its uint16 bits) and the name
    of its dtype ("bfloat16", "float32", ...). Always a copy: a CPU leaf's
    ``.cpu()`` is the leaf itself, which training updates in place while
    the background thread writes."""
    name = str(t.dtype).removeprefix("torch.")
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype in _NUMPY_OF:
        return t.view(torch.int16).numpy().view(_NUMPY_OF[t.dtype]), name
    return t.numpy(), name


def _leaf_files(leaf: np.ndarray, n_shards: int) -> List[np.ndarray]:
    if leaf.ndim == 0 or leaf.shape[0] < n_shards or n_shards == 1:
        return [leaf]
    return np.array_split(leaf, n_shards, axis=0)


def _write_snapshot(directory: str, step: int, leaves, names, spec,
                    extras: Optional[Dict], n_shards: int) -> str:
    tmp = os.path.join(directory, f"ckpt_{step}.tmp")
    final = os.path.join(directory, f"ckpt_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": repr(spec), "n_leaves": len(leaves),
                "extras": extras or {}, "leaves": []}
    for i, (leaf, name) in enumerate(zip(leaves, names)):
        shards = _leaf_files(leaf, n_shards)
        manifest["leaves"].append({
            "id": i, "dtype": name, "shape": list(leaf.shape),
            "n_shards": len(shards),
            "shard_shapes": [list(sh.shape) for sh in shards],
        })
        for k, sh in enumerate(shards):
            raw = np.frombuffer(np.ascontiguousarray(sh).tobytes(), np.uint8)
            with open(os.path.join(tmp, f"leaf{i}.s{k}.npy"), "wb") as f:
                np.save(f, raw)
                f.flush()
                os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(final, "COMMIT"), "w") as f:
        f.write("ok")
    return final


def _snapshot(tree):
    leaves, spec = flatten(tree)
    host = [_host(t) for t in leaves]
    return [h for h, _ in host], [n for _, n in host], spec


def save_checkpoint(directory: str, step: int, tree: Any,
                    extras: Optional[Dict] = None, n_shards: int = 1) -> str:
    """Synchronous save. Returns the committed checkpoint path."""
    leaves, names, spec = _snapshot(tree)
    return _write_snapshot(directory, step, leaves, names, spec, extras,
                           n_shards)


def latest_step(directory: str) -> Optional[int]:
    """Newest *committed* checkpoint step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def load_checkpoint(directory: str, step: int, tree_like: Any,
                    rules: Any = None, phase: str = "train",
                    cfg: Any = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``, each leaf on the
    device and in the dtype of its counterpart there. Returns
    ``(tree, extras)``.

    With ``rules`` on a rank grid (and the model's ``cfg``) the checkpoint
    holds the whole model tree, and each leaf comes back as the rank's
    slice of it (``launch.sharding.shard_params`` for ``phase``), read on
    the host and moved alone; ``tree_like`` may be the whole tree or the
    rank's (its shapes are checked against the one it matches)."""
    path = os.path.join(directory, f"ckpt_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, spec = flatten(tree_like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"restore target has {len(leaves_like)}")
    whole = []
    for i, (like, info) in enumerate(zip(leaves_like, manifest["leaves"])):
        dt = _np_dtype(info["dtype"])
        parts = []
        for k in range(info["n_shards"]):
            raw = np.load(os.path.join(path, f"leaf{i}.s{k}.npy"))
            parts.append(np.frombuffer(raw.tobytes(), dt)
                         .reshape(info["shard_shapes"][k]))
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if list(arr.shape) != info["shape"]:
            raise ValueError(f"leaf {i} shape mismatch")
        t = torch.from_numpy(np.array(arr))
        if info["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        whole.append(t)
    host = unflatten(spec, whole)
    if rules is not None and rules.grid is not None:
        from repro_torch.launch.sharding import shard_params
        if cfg is None:
            raise ValueError("load_checkpoint: slicing onto a grid needs "
                             "the model's cfg")
        host = shard_params(cfg, host, rules, phase)
    out = []
    for i, (t, like, w) in enumerate(zip(flatten(host)[0], leaves_like,
                                         whole)):
        shape = tuple(like.shape)
        if t.dtype != like.dtype or shape not in (tuple(t.shape),
                                                  tuple(w.shape)):
            raise ValueError(f"leaf {i}: checkpoint {t.dtype} "
                             f"{tuple(t.shape)}, target {like.dtype} "
                             f"{shape}")
        out.append(t.to(like.device))
    return unflatten(spec, out), manifest["extras"]


class Checkpointer:
    """Async wrapper: snapshot on the caller thread, write in background."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 1):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self.clean()

    def clean(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def wait(self) -> None:
        """Join the background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extras: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        # host copies, taken before training updates the tensors in place
        leaves, names, spec = _snapshot(tree)

        def work():
            _write_snapshot(self.directory, step, leaves, names, spec,
                            extras, self.n_shards)
            self._gc()

        def guarded():
            try:
                work()
            except Exception as e:   # reported by wait()
                self._error = e

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("ckpt_") and not n.endswith(".tmp")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"ckpt_{s}"),
                          ignore_errors=True)

    def restore_latest(self, tree_like: Any):
        step = latest_step(self.directory)
        if step is None:
            return None, None, {}
        tree, extras = load_checkpoint(self.directory, step, tree_like)
        return step, tree, extras
