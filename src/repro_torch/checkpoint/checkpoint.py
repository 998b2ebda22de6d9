"""Checkpoints as npz shards + a JSON manifest, in the reference package's
on-disk format, with numpy alone.

Layout:  <dir>/step_<N>/
             manifest.json      — step, leaf paths, dtypes, shapes, extra
             shard_0.npz        — the leaves as ``leaf_<i>`` arrays
         <dir>/step_<N>.done    — commit marker, written after the rename

The state is a flat dict of arrays; its keys are the leaf paths, in
sorted order, as the reference's pytree flattening of a dict gives them,
so each package reads the other's files. An interrupted save leaves no
``.done`` marker, so a restore always picks the last committed step.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np


def save_checkpoint(ckpt_dir, step: int, state: dict,
                    extra: Optional[dict] = None) -> Path:
    """Write ``state`` (leaf path → array) as step ``step`` and commit it:
    write to a temporary directory, rename it into place, then touch
    ``step_<step>.done``. Returns the step directory."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"_tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    paths = sorted(state)
    arrays = {f"leaf_{i}": np.asarray(state[p]) for i, p in enumerate(paths)}
    np.savez(tmp / "shard_0.npz", **arrays)
    manifest = {
        "step": step,
        "saved_unix": time.time(),
        "n_leaves": len(paths),
        "leaf_paths": paths,
        "leaf_dtypes": [str(a.dtype) for a in arrays.values()],
        "leaf_shapes": [list(a.shape) for a in arrays.values()],
        "mesh": None,
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
