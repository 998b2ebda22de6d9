"""repro_torch.reach — the serving facade of the PyTorch/CUDA port.

    from repro_torch import reach

    spec = reach.IndexSpec(k=2, variant="G")
    ix = reach.build(g, spec)                    # host FERRARI build
    sess = reach.QuerySession(ix, spec)          # device="cuda" by default
    answers = sess.query(srcs, dsts)             # bucketed micro-batches
    print(sess.stats)                            # SessionStats

    spec = reach.IndexSpec(builder="wavefront", cover_method="topgap")
    ix = reach.build(g, spec)                    # device build, on the card
    reach.save_index(path, ix, spec)             # artifact on disk
    sess = reach.QuerySession.load(path)         # serve it again later

    sess.apply_updates(srcs, dsts)               # live inserts (overlay)
    sess.compact()                               # fold them into the index

    fe = reach.Frontend(sess)                    # multi-tenant, deadlines
    t = fe.submit("tenant-a", srcs, dsts)        # may raise Rejected
    answers = fe.drain()[t]

A loaded session is bound to its artifact: inserts append to its delta
log, ``compact`` saves the next epoch, and ``load`` replays the log
(``reach.dynamic``, ``reach.persist``).

Artifacts share the reference package's format; ``index_from_arrays``
rebuilds an index from an artifact's leaves.
"""
from .convert import index_from_arrays                      # noqa: F401
from .frontend import Frontend, FrontendStats, Rejected     # noqa: F401
from .persist import (IndexArtifact, load_index,            # noqa: F401
                      load_manifest, save_index)
from .session import QuerySession, SessionStats             # noqa: F401
from .spec import IndexSpec, build, make_engine             # noqa: F401

__all__ = ["IndexSpec", "build", "make_engine", "QuerySession",
           "SessionStats", "index_from_arrays", "IndexArtifact",
           "save_index", "load_index", "load_manifest", "Frontend",
           "FrontendStats", "Rejected"]
