"""Host-side FERRARI index: build, packing and the reference DFS engine
(numpy copies of the reference package's host modules) plus the
two-phase device engine (``query_torch``)."""
