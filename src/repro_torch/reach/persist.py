"""Index persistence — a built FerrariIndex as an on-disk artifact.

Construction takes minutes at web scale; serving must start in seconds.
``save_index`` stores the complete queryable state through the
``checkpoint/`` layer (npz shard + JSON manifest + atomic ``.done``
commit) in the reference package's format, so an artifact written by
either package loads in the other. Beyond the FerrariIndex it saves the
``PackedIndex`` interval slabs and the ELL + COO-tail adjacency of the
sparse phase 2: both come from host loops over all n nodes, and with them
``load_index`` is a pure array read (``convert.index_from_arrays``).

Edge inserts between compactions live in an append-only delta log beside
the artifact steps (``append_delta``/``load_deltas``), with the
reference's file names and npz keys, so a log either package writes
replays in the other (``QuerySession.load``).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..checkpoint.checkpoint import latest_step, save_checkpoint
from ..core.ferrari import FerrariIndex
from ..core.packed import PackedIndex, pack_index
from .convert import index_from_arrays
from .spec import IndexSpec

FORMAT_VERSION = 1


@dataclass
class IndexArtifact:
    """A loaded index plus everything needed to serve it immediately."""
    index: FerrariIndex
    spec: Optional[IndexSpec]
    packed: Optional[PackedIndex]
    ell: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    manifest: dict
    epoch: int = 0            # graph epoch of the artifact


def _flatten_labels(labels, n_aug: int):
    indptr = np.zeros(n_aug + 1, dtype=np.int64)
    for v in range(n_aug):
        indptr[v + 1] = indptr[v] + labels[v][0].size
    begins = np.concatenate([labels[v][0] for v in range(n_aug)])
    ends = np.concatenate([labels[v][1] for v in range(n_aug)])
    exact = np.concatenate([labels[v][2] for v in range(n_aug)])
    return indptr, begins.astype(np.int64), ends.astype(np.int64), exact


def save_index(path, index: FerrariIndex, spec: Optional[IndexSpec] = None,
               meta: Optional[dict] = None,
               packed: Optional[PackedIndex] = None,
               ell=None, epoch: int = 0) -> Path:
    """Persist ``index`` (and its serving layouts) under ``path``; returns
    the committed step directory.

    ``spec`` travels in the manifest so a loader can rebuild the engine
    configuration; ``meta`` is JSON-serializable caller context (e.g.
    which graph the index was built over), stored as
    ``extra["user_meta"]``. ``packed`` / ``ell`` (an (ell, tail_src,
    tail_dst) tuple) reuse layouts already built for a session; both are
    O(n) host loops. ``epoch`` names the step (0 for a fresh build).
    """
    tl, cond = index.tl, index.cond
    n_aug = tl.n + 1
    lab_indptr, lab_begins, lab_ends, lab_exact = _flatten_labels(
        index.labels, n_aug)
    state = {
        "comp": cond.comp,
        "comp_size": cond.comp_size,
        "dag_indptr": cond.dag.indptr,
        "dag_indices": cond.dag.indices,
        "tau": tl.tau, "pi": tl.pi, "tbegin": tl.tbegin,
        "parent": tl.parent, "blevel": tl.blevel,
        "tree_indptr": tl.tree_children.indptr,
        "tree_indices": tl.tree_children.indices,
        "lab_indptr": lab_indptr, "lab_begins": lab_begins,
        "lab_ends": lab_ends, "lab_exact": lab_exact,
    }
    if index.seeds is not None:
        state["seed_ids"] = index.seeds.seed_ids
        state["s_plus"] = index.seeds.s_plus
        state["s_minus"] = index.seeds.s_minus
    extra = {
        "format_version": FORMAT_VERSION,
        "kind": "ferrari-index",
        "epoch": int(epoch),
        "n_comp": int(cond.n_comp),
        "k": (None if index.k is None else int(index.k)),
        "variant": index.variant,
        "stats": asdict(index.stats),
        "spec": (None if spec is None else spec.to_dict()),
        "user_meta": (meta or {}),
    }
    pk = pack_index(index) if packed is None else packed
    if ell is None:
        ell = pk.ell_layout(width=None if spec is None else spec.ell_width)
    ell_slab, tail_src, tail_dst = ell
    state.update({
        "pk_begins": pk.begins, "pk_ends": pk.ends, "pk_exact": pk.exact,
        "ell": ell_slab, "tail_src": tail_src, "tail_dst": tail_dst,
    })
    extra["k_max"] = int(pk.k_max)
    extra["max_out_degree"] = int(pk.max_out_degree)
    return save_checkpoint(path, step=int(epoch), state=state, extra=extra)


def load_manifest(path, step: Optional[int] = None) -> dict:
    """The JSON manifest of the latest committed artifact (no array load),
    so a caller can read the stored spec and user metadata first."""
    path = Path(path)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed index artifact under {path}")
    return json.loads((path / f"step_{step}" / "manifest.json").read_text())


def _load_arrays(path, step: Optional[int]):
    path = Path(path)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed index artifact under {path}")
    d = path / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest["extra"].get("kind") != "ferrari-index":
        raise ValueError(f"{d} is not a ferrari-index artifact")
    ver = manifest["extra"].get("format_version")
    if ver != FORMAT_VERSION:
        raise ValueError(f"unsupported index format_version {ver!r} "
                         f"(this build reads {FORMAT_VERSION})")
    with np.load(d / "shard_0.npz") as z:
        arrays = {p: z[f"leaf_{i}"]
                  for i, p in enumerate(manifest["leaf_paths"])}
    return arrays, manifest


def load_index(path, step: Optional[int] = None) -> IndexArtifact:
    """Load the latest committed index artifact under ``path`` (the edge
    inserts logged since its epoch are ``load_deltas``')."""
    arrays, manifest = _load_arrays(path, step)
    extra = manifest["extra"]
    epoch = int(extra.get("epoch", 0))
    index, packed, ell = index_from_arrays(arrays, extra)
    spec = (None if extra.get("spec") is None
            else IndexSpec.from_dict(extra["spec"]))
    return IndexArtifact(index=index, spec=spec, packed=packed, ell=ell,
                         manifest=manifest, epoch=epoch)


# ------------------------------------------------------------ delta log --
#
# Edge inserts between compactions live in an append-only log BESIDE the
# artifact steps: one npz per applied batch, named by the graph epoch it
# extends. Compaction bumps the epoch and commits a new artifact step, so
# older epochs' batches become inert history — never rewritten, never
# deleted, just no longer selected by the loader.

def delta_log_dir(path) -> Path:
    return Path(path) / "deltas"


def next_delta_seq(path, epoch: int) -> int:
    """Number of log batches already on disk for ``epoch`` (= the next
    sequence number). Sessions list once and count in memory after."""
    d = delta_log_dir(path)
    if not d.exists():
        return 0
    return len(list(d.glob(f"epoch_{int(epoch):08d}_*.npz")))


def append_delta(path, epoch: int, src, dst,
                 seq: Optional[int] = None) -> Path:
    """Append one batch of ORIGINAL-id edge inserts to the delta log.

    Original ids (not condensed): a full-rebuild compaction can change the
    SCC map, and replay re-condenses through whatever comp map the loaded
    artifact carries. Atomic tmp-write + rename, sequence-numbered within
    the epoch so replay order is total; ``seq=None`` re-derives the
    number by listing (``QuerySession`` passes its in-memory cursor).
    """
    d = delta_log_dir(path)
    d.mkdir(parents=True, exist_ok=True)
    if seq is None:
        seq = next_delta_seq(path, epoch)
    out = d / f"epoch_{int(epoch):08d}_{seq:08d}.npz"
    tmp = out.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, src=np.asarray(src, dtype=np.int64),
                 dst=np.asarray(dst, dtype=np.int64))
    tmp.rename(out)
    return out


def load_deltas(path, epoch: int):
    """The logged insert batches extending artifact ``epoch``, in append
    order: a list of (src, dst) original-id arrays."""
    d = delta_log_dir(path)
    if not d.exists():
        return []
    out = []
    for f in sorted(d.glob(f"epoch_{int(epoch):08d}_*.npz")):
        with np.load(f) as z:
            out.append((z["src"], z["dst"]))
    return out
