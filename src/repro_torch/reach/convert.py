"""Rebuild a servable index from the arrays of a saved index artifact.

The reference package's ``reach.persist.save_index`` writes an index as
flat numpy leaves plus a JSON ``extra`` dict. ``index_from_arrays`` takes
those leaves under the same names (``comp``, ``dag_indptr``, ``tau``, …,
``lab_*``, ``s_plus``/``s_minus``/``seed_ids``, ``pk_*``, ``ell``,
``tail_*``) and rebuilds this package's ``FerrariIndex`` and, when the
packed leaves are present, its ``PackedIndex`` and ELL triple, with no
host packing loop. An artifact loader only has to add the file read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.ferrari import BuildStats, FerrariIndex
from ..core.packed import PackedIndex
from ..core.scc import Condensation
from ..core.seeds import SeedLabels
from ..core.tree_cover import TreeLabels
from ..graphs.csr import CSR


def index_from_arrays(arrays: dict, extra: dict) -> Tuple[
        FerrariIndex, Optional[PackedIndex],
        Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """(index, packed, ell) from artifact leaves and manifest ``extra``;
    ``packed`` and ``ell`` are None when the artifact holds no packed
    layout."""
    a = arrays
    n = int(extra["n_comp"])
    dag = CSR(n=n, indptr=a["dag_indptr"], indices=a["dag_indices"])
    cond = Condensation(comp=a["comp"], n_comp=n, dag=dag,
                        comp_size=a["comp_size"])
    tl = TreeLabels(
        n=n, tau=a["tau"], pi=a["pi"], tbegin=a["tbegin"],
        parent=a["parent"], blevel=a["blevel"],
        tree_children=CSR(n=n + 1, indptr=a["tree_indptr"],
                          indices=a["tree_indices"]))
    lp = a["lab_indptr"]
    lb, le, lx = a["lab_begins"], a["lab_ends"], a["lab_exact"]
    labels = [(lb[lp[v]:lp[v + 1]], le[lp[v]:lp[v + 1]],
               lx[lp[v]:lp[v + 1]]) for v in range(n + 1)]
    seeds = None
    if "seed_ids" in a:
        seeds = SeedLabels(seed_ids=a["seed_ids"], s_plus=a["s_plus"],
                           s_minus=a["s_minus"])
    index = FerrariIndex(
        cond=cond, tl=tl, labels=labels, seeds=seeds,
        k=extra["k"], variant=extra["variant"],
        stats=BuildStats(**extra["stats"]))
    if "pk_begins" not in a:
        return index, None, None
    packed = PackedIndex(
        n=n, k_max=int(extra["k_max"]),
        begins=a["pk_begins"], ends=a["pk_ends"], exact=a["pk_exact"],
        pi=tl.pi[:n].astype(np.int32),
        tau=tl.tau[:n].astype(np.int32),
        blevel=tl.blevel[:n].astype(np.int32),
        s_plus=(None if seeds is None else seeds.s_plus),
        s_minus=(None if seeds is None else seeds.s_minus),
        adj_indptr=dag.indptr.astype(np.int32),
        adj_indices=dag.indices.astype(np.int32),
        comp=cond.comp.astype(np.int32),
        max_out_degree=int(extra["max_out_degree"]))
    return index, packed, (a["ell"], a["tail_src"], a["tail_dst"])
