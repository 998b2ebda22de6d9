"""repro_torch.core.build — the staged device construction pipeline.

Stages: PLAN (wave schedule + fit/hub split under the working-width cap)
→ WAVES (per-level-sized single-shot merges + chunked tree-reduction merge
for hub fan-in, on the device through kernel 5) → DRAIN (variant "G"
post-hoc budget recovery, on the host).
"""
from .merge_kernels import INVALID, merge_cover_rows, slab_bytes  # noqa: F401
from .pipeline import (DEFAULT_MERGE_CHUNK, SINGLE_SHOT_DEG,  # noqa: F401
                       WavefrontIndex, build_index_device, build_wavefront,
                       effective_widths, labels_from_wavefront,
                       prior_peak_slab_bytes)
from .tree_merge import MergeStats, plan_chunks, reduce_wave  # noqa: F401

__all__ = [
    "INVALID", "merge_cover_rows", "slab_bytes",
    "DEFAULT_MERGE_CHUNK", "SINGLE_SHOT_DEG", "WavefrontIndex",
    "build_index_device", "build_wavefront", "effective_widths",
    "labels_from_wavefront", "prior_peak_slab_bytes",
    "MergeStats", "plan_chunks", "reduce_wave",
]
