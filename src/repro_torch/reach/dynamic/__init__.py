"""repro_torch.reach.dynamic — live-graph updates for a serving QuerySession.

The static FERRARI index becomes a dynamic oracle in three pieces, with
the reference's semantics (``repro.reach.dynamic``):

  * :class:`DeltaOverlay` (overlay.py) — inserted edges as a fixed-capacity
    COO slab on the engine's device; queries answer ``base_index_hit OR
    union-graph BFS``, sound and complete the moment ``apply_updates()``
    returns.
  * :func:`compact_index` (relabel.py) — bounded incremental relabeling:
    only the labels of union-graph ancestors of the inserted tails are
    recomputed, through the affected waves of the staged device pipeline
    (kernel 5 on a card); full rebuild is the explicit fallback.
  * epoch-versioned persistence (``reach.persist``) — an append-only delta
    log beside the artifact plus an ``epoch`` manifest field, so
    ``QuerySession.load`` replays to the current graph.

Driven through ``QuerySession.apply_updates()`` / ``.compact()``.
"""
from .overlay import DeltaOverlay, OverlayFull           # noqa: F401
from .relabel import (COMPACT_MODES, affected_set,       # noqa: F401
                      compact_index, union_dag)

__all__ = ["DeltaOverlay", "OverlayFull", "compact_index", "affected_set",
           "union_dag", "COMPACT_MODES"]
