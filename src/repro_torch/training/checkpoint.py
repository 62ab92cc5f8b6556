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
leaf of the tree it is given.

On a rank grid a tree holds the rank's slices, cut as a tree of
``launch.sharding.Cuts`` says (``param_cuts``, ``opt_cuts``). A save from
the grid gathers each leaf whole on rank 0's host, one leaf at a time on
the caller's thread (a collective cannot run on the writer thread); rank
0 alone keeps the snapshot and writes it, in the layout above, so a
checkpoint from a grid is a whole one and reads anywhere; the other ranks
wait at a barrier until it is committed. A restore with the cuts of the
tree it fills (the counterpart of the reference's ``shardings=``) reads
each leaf whole on the host and keeps the rank's slice of it, so a
checkpoint restores onto any grid, or onto one device without cuts.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten

__all__ = ["Checkpointer", "save_checkpoint", "load_checkpoint",
           "latest_step"]

_NUMPY_OF = {torch.bfloat16: np.uint16}


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf's host copy as numpy (bf16 as its uint16 bits) and the name
    of its dtype ("bfloat16", "float32", ...). Always a copy: a CPU leaf's
    ``.cpu()`` is the leaf itself, which training updates in place while
    the background thread writes."""
    return _numpy(t.detach().to("cpu", copy=True).contiguous())


def _numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A contiguous host tensor as numpy, sharing its memory, and the
    name of its dtype."""
    name = str(t.dtype).removeprefix("torch.")
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
            raw = np.ascontiguousarray(sh).reshape(-1).view(np.uint8)
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


def _snapshot(tree, cuts=None, grid=None):
    """The host snapshot of ``tree`` — ``(leaves, dtype names, spec)`` —
    and, with the ``cuts`` of a rank's slices on ``grid``, of the whole
    tree: each leaf gathered whole on rank 0's host, one at a time
    (``launch.sharding.gather_to_rank0``); ``None`` on the other ranks."""
    leaves, spec = flatten(tree)
    if cuts is None or grid is None:
        host = [_host(t) for t in leaves]
    else:
        from repro_torch.launch.sharding import gather_to_rank0
        host = []
        for t, c in zip(leaves, _cut_leaves(cuts, spec)):
            whole = gather_to_rank0(t, c, grid)
            if whole is not None:
                host.append(_numpy(whole))
        if grid.rank != 0:
            return None
    return [h for h, _ in host], [n for _, n in host], spec


def _cut_leaves(cuts, spec) -> list:
    flat, cut_spec = flatten(cuts)
    if cut_spec != spec:
        raise ValueError("the tree and its cuts differ in structure")
    return flat


def save_checkpoint(directory: str, step: int, tree: Any,
                    extras: Optional[Dict] = None, n_shards: int = 1,
                    cuts: Any = None, grid: Any = None) -> str:
    """Synchronous save. Returns the committed checkpoint path. With the
    ``cuts`` of a rank's slices on ``grid`` every rank of the grid calls
    it: the whole tree is written once, by rank 0, and every rank returns
    once it is committed."""
    snap = _snapshot(tree, cuts, grid)
    final = os.path.join(directory, f"ckpt_{step}")
    if snap is not None:
        final = _write_snapshot(directory, step, *snap, extras, n_shards)
    if cuts is not None and grid is not None:
        dist.barrier()
    return final


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
                    cfg: Any = None, cuts: Any = None,
                    grid: Any = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``, each leaf on the
    device and in the dtype of its counterpart there. Returns
    ``(tree, extras)``.

    With ``cuts`` (a tree of ``launch.sharding.Cuts`` matching
    ``tree_like``, e.g. ``{"params": param_cuts(...), "opt":
    opt_cuts(...)}``) and the ``grid`` they cut on, each leaf of the
    checkpoint (written whole, or from any grid) comes back as the rank's
    slice of it, read on the host and moved alone; ``tree_like`` may hold
    the whole leaves or the rank's (each shape is checked against the one
    it matches). ``rules`` on a grid with the model's ``cfg`` stands for
    the params' cuts, ``param_cuts(cfg, rules, phase)`` on
    ``rules.grid``."""
    path = os.path.join(directory, f"ckpt_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, spec = flatten(tree_like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"restore target has {len(leaves_like)}")
    if rules is not None and rules.grid is not None:
        from repro_torch.launch.sharding import param_cuts
        if cfg is None:
            raise ValueError("load_checkpoint: slicing onto a grid needs "
                             "the model's cfg")
        cuts, grid = param_cuts(cfg, rules, phase), rules.grid
    flat_cuts = ([None] * len(leaves_like) if cuts is None
                 else _cut_leaves(cuts, spec))
    out = []
    for i, (like, info, c) in enumerate(zip(leaves_like,
                                            manifest["leaves"], flat_cuts)):
        dt = _np_dtype(info["dtype"])
        parts = []
        for k in range(info["n_shards"]):
            raw = np.load(os.path.join(path, f"leaf{i}.s{k}.npy"))
            parts.append(raw.view(dt).reshape(info["shard_shapes"][k]))
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if list(arr.shape) != info["shape"]:
            raise ValueError(f"leaf {i} shape mismatch")
        whole = torch.from_numpy(arr)
        if info["dtype"] == "bfloat16":
            whole = whole.view(torch.bfloat16)
        t = whole
        if c is not None and c.pairs:
            if grid is None:
                raise ValueError("load_checkpoint: cuts without the grid "
                                 "they cut on")
            from repro_torch.launch.sharding import cut_tree
            t = cut_tree(whole, c, grid)
        shape = tuple(like.shape)
        if t.dtype != like.dtype or shape not in (tuple(t.shape),
                                                  tuple(whole.shape)):
            raise ValueError(f"leaf {i}: checkpoint {t.dtype} "
                             f"{tuple(t.shape)}, target {like.dtype} "
                             f"{shape}")
        out.append(t.to(like.device))
    return unflatten(spec, out), manifest["extras"]


class Checkpointer:
    """Async wrapper: snapshot on the caller thread, write in background.
    On a grid (``save(..., cuts=, grid=)``) every rank calls it alike:
    every rank takes part in the snapshot's gather, rank 0 writes, and
    :meth:`wait` (every rank's, before the next save or at the end) holds
    the ranks at a barrier until rank 0's write is committed."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 1):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False
        os.makedirs(directory, exist_ok=True)
        self.clean()

    def clean(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def wait(self) -> None:
        """Join the background save (and, after a save from a grid, meet
        the other ranks once it is committed); raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extras: Optional[Dict] = None,
             blocking: bool = False, cuts: Any = None,
             grid: Any = None) -> None:
        self.wait()
        # host copies, taken before training updates the tensors in place
        snap = _snapshot(tree, cuts, grid)
        self._barrier = cuts is not None and grid is not None

        def work():
            if snap is not None:
                _write_snapshot(self.directory, step, *snap, extras,
                                self.n_shards)
                self._gc()

        def guarded():
            try:
                work()
            except Exception as e:   # reported by wait()
                self._error = e

        if blocking:
            try:
                work()
            finally:
                self.wait()
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

    def restore_latest(self, tree_like: Any, cuts: Any = None,
                       grid: Any = None):
        """The newest committed checkpoint restored into ``tree_like``
        (with ``cuts`` on ``grid``: the rank's slices; see
        :func:`load_checkpoint`): ``(step, tree, extras)``, or ``(None,
        None, {})`` when there is none."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, {}
        tree, extras = load_checkpoint(self.directory, step, tree_like,
                                       cuts=cuts, grid=grid)
        return step, tree, extras
