"""Checkpoints as npz shards + a JSON manifest, in the reference package's
on-disk format, and the trainer's asynchronous ``CheckpointManager``.

Layout:  <dir>/step_<N>/
             manifest.json      — step, leaf paths, dtypes, shapes, extra
             shard_0.npz        — the leaves as ``leaf_<i>`` arrays
         <dir>/step_<N>.done    — commit marker, written after the rename

A state is a tree of dicts, lists and arrays or tensors. Its leaves are
written in the reference's pytree order (dict keys sorted, lists in
order) under its leaf paths (keys and list indices joined by ``/``), so
each package reads the other's files. bfloat16 leaves are stored as the
reference stores them (2-byte void, dtype name ``bfloat16`` in the
manifest). An interrupted save leaves no ``.done`` marker, so a restore
always picks the last committed step.

On a mesh (one process a rank) each rank holds blocks of the leaves:
``CheckpointManager.save(..., mesh=, placements=)`` gathers every leaf
whole (every rank of the mesh takes part), and the mesh's first rank
writes it with the mesh in the manifest (``{"axis_names", "shape"}``),
as the reference's single process writes whole arrays. A restore with
``placements`` loads the whole leaves on every rank and keeps the rank's
block under them, whatever mesh wrote the files (the elastic restore).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import gather, local_slice


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(leaf path, leaf)] in the reference's pytree order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _flatten_with_paths(tree[key], f"{prefix}{key}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, value in enumerate(tree)
                for item in _flatten_with_paths(value, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _tree_map(fn, tree):
    """``fn`` over the leaves, visited in ``_flatten_with_paths``' order."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key]) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, value) for value in tree]
    return fn(tree)


def _to_numpy(leaf):
    """(array to write, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        leaf = t.numpy()
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _mesh_entry(mesh) -> Optional[dict]:
    if mesh is None:
        return None
    return {"axis_names": list(mesh.axis_names),
            "shape": [int(n) for n in mesh.shape]}


def save_checkpoint(ckpt_dir, step: int, state,
                    extra: Optional[dict] = None, mesh=None) -> Path:
    """Write ``state`` (whole leaves) as step ``step`` and commit it:
    write to a temporary directory, rename it into place, then touch
    ``step_<step>.done``; ``mesh``: the mesh that trained it, recorded in
    the manifest. Returns the step directory."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"_tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flatten_with_paths(state)
    paths = [p for p, _ in flat]
    written = [_to_numpy(leaf) for _, leaf in flat]
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(written)}
    np.savez(tmp / "shard_0.npz", **arrays)
    manifest = {
        "step": step,
        "saved_unix": time.time(),
        "n_leaves": len(paths),
        "leaf_paths": paths,
        "leaf_dtypes": [name for _, name in written],
        "leaf_shapes": [list(a.shape) for a, _ in written],
        "mesh": _mesh_entry(mesh),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                        # atomic commit (same fs)
    (ckpt_dir / f"step_{step}.done").touch()
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for marker in ckpt_dir.glob("step_*.done"):
        try:
            s = int(marker.stem.split("_")[1])
        except (IndexError, ValueError):
            continue
        if (ckpt_dir / f"step_{s}" / "manifest.json").exists():
            steps.append(s)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, step: Optional[int] = None):
    """(state, manifest) of step ``step`` (default: the latest committed
    one), the state as a dict leaf path → numpy array; (None, None) when
    nothing is committed."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_0.npz") as z:
        state = {p: z[f"leaf_{i}"]
                 for i, p in enumerate(manifest["leaf_paths"])}
    return state, manifest


def restore_like(ckpt_dir, state_like, step: Optional[int] = None,
                 placements=None):
    """(state, manifest) of step ``step`` (default: the latest committed
    one) in the tree of ``state_like``, each leaf a tensor on that leaf's
    device and of its dtype; (None, None) when nothing is committed.
    ``placements`` (a tree of ``parallel.sharding.Placement`` matching
    ``state_like``): each leaf is this rank's block of the whole under
    its placement. Raises ``ValueError`` where the leaf paths or shapes
    differ from ``state_like``'s."""
    arrays, manifest = restore_checkpoint(ckpt_dir, step)
    if arrays is None:
        return None, None
    like = dict(_flatten_with_paths(state_like))
    if set(like) != set(arrays):
        raise ValueError(
            "checkpoint/state structure mismatch: only in the checkpoint "
            f"{sorted(set(arrays) - set(like))}, only in the state "
            f"{sorted(set(like) - set(arrays))}")
    names = dict(zip(manifest["leaf_paths"], manifest["leaf_dtypes"]))
    paths = iter(p for p, _ in _flatten_with_paths(state_like))
    where = dict(_flatten_with_paths(placements)) if placements else {}

    def one(leaf):
        path = next(paths)
        t = _to_tensor(arrays[path], names[path])
        if path in where:
            t = local_slice(t, where[path].spec, where[path].mesh)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {path}: shape "
                             f"{tuple(t.shape)}, state {tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return _tree_map(one, state_like), manifest


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def gather_state(state, placements):
    """``state`` with every leaf made whole from the ranks' blocks under
    ``placements`` (``parallel.sharding.gather``; every rank of the mesh
    must call it)."""
    where = dict(_flatten_with_paths(placements))
    paths = iter(p for p, _ in _flatten_with_paths(state))

    def one(leaf):
        p = where[next(paths)]
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        return gather(leaf, p.spec, p.mesh)
    return _tree_map(one, state)


class CheckpointManager:
    """Background writer with retention: ``save`` copies the state to the
    host before it returns (the next step updates the params in place),
    then writes on a thread, one write in flight at a time; the last
    ``keep_last`` committed steps are kept. On a mesh, ``save`` gathers
    the leaves on every rank and only the mesh's first rank writes."""

    def __init__(self, ckpt_dir, keep_last: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.save_count = 0

    def wait(self):
        """Wait for the write in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state, extra: Optional[dict] = None,
             mesh=None, placements=None):
        """Commit ``state`` as step ``step``. ``placements``: the state is
        this rank's blocks, gathered whole first (a collective over the
        mesh); ``mesh``: recorded in the manifest, and only its first
        rank writes."""
        self.wait()                               # one in flight at a time
        if placements is not None:
            state = gather_state(state, placements)
            mesh = mesh if mesh is not None else next(
                p for _, p in _flatten_with_paths(placements)).mesh
        if mesh is not None and mesh.rank != mesh.ranks[0]:
            return
        host_state = _tree_map(_host_copy, state)

        def _do():
            try:
                save_checkpoint(self.dir, step, host_state, extra, mesh)
                self._gc()
            except Exception as e:                # re-raised by wait()
                self._error = e

        self.save_count += 1
        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
            self.wait()

    def _gc(self):
        steps = sorted(
            int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.done"))
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
            (self.dir / f"step_{s}.done").unlink(missing_ok=True)

    def restore_latest(self, state_like, placements=None):
        """(state, manifest) of the last committed step in ``state_like``'s
        tree, devices and dtypes, each leaf this rank's block under
        ``placements`` where given (``restore_like``); (None, None) when
        nothing is committed."""
        self.wait()
        return restore_like(self.dir, state_like, placements=placements)
