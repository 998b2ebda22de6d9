"""repro_torch.reach — the serving facade of the PyTorch/CUDA port.

    from repro_torch import reach

    spec = reach.IndexSpec(k=2, variant="G")
    ix = reach.build(g, spec)                    # host FERRARI build
    sess = reach.QuerySession(ix, spec)          # device="cuda" by default
    answers = sess.query(srcs, dsts)             # bucketed micro-batches
    print(sess.stats)                            # SessionStats

``index_from_arrays`` rebuilds an index from the leaves of an artifact
saved by the reference package.
"""
from .convert import index_from_arrays                      # noqa: F401
from .session import QuerySession, SessionStats             # noqa: F401
from .spec import IndexSpec, build, make_engine             # noqa: F401

__all__ = ["IndexSpec", "build", "make_engine", "QuerySession",
           "SessionStats", "index_from_arrays"]
