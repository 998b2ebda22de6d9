"""One BFS step of the sparse phase 2 on the CPU: kernel 3's plain version
(``expand_probe_plain``) and kernel 4's (``dedup_classify_emit_plain``)
against the reference's own step, assembled from its pieces exactly as
``repro.kernels.frontier_fused.expand_frontier_loop_fused`` assembles them
(the gathers, ``_row_call(_probe_kernel)``, the prefix-sum compaction into
cap + 1 slots, ``jnp.unique(size=cap + 1)`` and ``_classify_call``, all
with ``interpret=True``), step after step from the same state. Every value
is an integer: exact equality. The reference's front keeps SENTINEL
holes; the port's state takes it as it is (``N_FRONT = cap``) and emits a
dense front, which must hold the reference's live keys in order."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ferrari import build_index as ref_build
from repro.core.packed import pack_index as ref_pack
from repro.graphs import generators as ref_gen
from repro.kernels import ref as jref
from repro.kernels.frontier import _bit as ref_bit
from repro.kernels.frontier_fused import (_classify_call, _probe_kernel,
                                          _row_call)
from repro_torch.core.ferrari import build_index
from repro_torch.core.packed import pack_index
from repro_torch.core.workload import positive_queries, random_queries
from repro_torch.graphs import generators as gen
from repro_torch.kernels import frontier_fused as ff
from repro_torch.kernels.frontier import SENTINEL, _bit, key_bits, or_bits

BLOCK = 256


def _t(a):
    a = np.array(a)                 # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


class Index:
    """One index built by both packages, its ELL layout and the port's
    meta/slab and the reference's device dict."""

    def __init__(self, graph, k, variant, width):
        kw = dict(k=k, variant=variant, use_seeds=False)
        self.g = graph(gen)
        self.p = pack_index(build_index(self.g, **kw))
        self.dev_ref = ref_pack(ref_build(graph(ref_gen), **kw)).to_device()
        ell, tsrc, tdst = self.p.ell_layout(width=width)
        is_hub = np.zeros(self.p.n, bool)
        is_hub[tsrc] = True
        self.np = dict(ell=ell, tail_src=tsrc, tail_dst=tdst, is_hub=is_hub)
        self.t = {k: _t(v) for k, v in self.np.items()}
        dev = self.p.to_torch("cpu")
        self.meta, self.slab = dev["meta"], dev["slab"]

    def queries(self, n_rand, n_pos, seed):
        qs, qt = random_queries(self.g, n_rand, seed=seed)
        ps, pt = positive_queries(self.g, n_pos, seed=seed + 1)
        qs, qt = np.concatenate([qs, ps]), np.concatenate([qt, pt])
        return (self.p.comp[qs].astype(np.int32),
                self.p.comp[qt].astype(np.int32))


def ref_step(ix, front, visited, pos, ct, cap):
    """The reference's loop body (frontier_fused.py:159-239) from its
    pieces. front [cap] int32 with holes, visited [Q, W] uint32, pos [Q]
    bool. Returns its compaction (slots, raw), its unique, the emitted keys
    before the answered mask (fkey), and the next (front, visited, pos,
    step overflow)."""
    ell, tsrc, tdst, is_hub = (jnp.asarray(ix.np[k]) for k in
                               ("ell", "tail_src", "tail_dst", "is_hub"))
    q, m_t, w = pos.shape[0], tsrc.shape[0], ell.shape[1]
    vbits = key_bits(ix.p.n)
    vmask = (1 << vbits) - 1
    front = jnp.asarray(front)
    visited = jnp.asarray(visited)
    pos = jnp.asarray(pos)
    fvalid = front != SENTINEL
    fq = jnp.where(fvalid, front >> vbits, 0)
    fv = jnp.where(fvalid, front & vmask, 0)
    nbr = ell[fv]
    cq = jnp.broadcast_to(fq[:, None], (cap, w)).reshape(-1)
    cv = nbr.reshape(-1)
    ok = (fvalid[:, None] & (nbr >= 0)).reshape(-1)
    hub = bool(m_t) and bool(jnp.any(is_hub[fv] & fvalid))
    if hub:
        fbits = jnp.zeros_like(visited).at[fq, fv >> 5].add(
            jnp.where(fvalid, ref_bit(fv), jnp.uint32(0)))
        act = (fbits[:, tsrc >> 5]
               >> (tsrc & 31).astype(jnp.uint32)[None, :]) & 1
        qi = jnp.arange(q, dtype=jnp.int32)
        cq = jnp.concatenate([cq, jnp.broadcast_to(qi[:, None],
                                                   (q, m_t)).reshape(-1)])
        cv = jnp.concatenate([cv, jnp.broadcast_to(tdst[None, :],
                                                   (q, m_t)).reshape(-1)])
        ok = jnp.concatenate([ok, (act == 1).reshape(-1)])
    cq = jnp.where(ok, cq, 0)
    cv = jnp.where(ok, cv, 0)
    keys = _row_call(functools.partial(_probe_kernel, vbits=vbits),
                     (cq, cv, ok.astype(jnp.int32),
                      visited[cq, cv >> 5].view(jnp.int32),
                      pos[cq].astype(jnp.int32)),
                     block=BLOCK, interpret=True)
    emit = keys != SENTINEL
    raw = int(jnp.sum(emit.astype(jnp.int32)))
    slot = jnp.cumsum(emit.astype(jnp.int32)) - 1
    slot = jnp.where(emit & (slot <= cap), slot, cap + 1)
    compacted = jnp.full((cap + 1,), SENTINEL, jnp.int32).at[slot].set(
        keys, mode="drop")
    uniq = jnp.unique(compacted, size=cap + 1, fill_value=SENTINEL)
    overflow = (raw > cap + 1) | bool(uniq[cap] != SENTINEL)
    new = uniq[:cap]
    nvalid = new != SENTINEL
    nq = jnp.where(nvalid, new >> vbits, 0)
    nv = jnp.where(nvalid, new & vmask, 0)
    nt = jnp.asarray(ct)[nq]
    meta, slab = ix.dev_ref["meta"], ix.dev_ref["slab"]
    verdict, fkey = _classify_call(meta[nv], meta[nt], slab[nv], new,
                                   nv == nt, block=BLOCK, interpret=True)
    pos = pos.at[nq].max(nvalid & (verdict == jref.POS))
    visited = visited.at[nq, nv >> 5].add(
        jnp.where(nvalid, ref_bit(nv), jnp.uint32(0)))
    front = jnp.where(~pos[nq], fkey, SENTINEL)
    return dict(slots=np.asarray(compacted), raw=raw, uniq=np.asarray(uniq),
                fkey=np.asarray(fkey), hub=hub, front=np.asarray(front),
                visited=np.asarray(visited), pos=np.asarray(pos),
                overflow=bool(overflow))


def port_state(ix, front, visited, pos, cap, step):
    """The port's StepState holding the reference's state (front with its
    holes, N_FRONT = cap), its hub bits set from the front."""
    q = pos.shape[0]
    st = ff.StepState(q=q, n_nodes=ix.p.n, w=ix.np["ell"].shape[1],
                      m_t=ix.np["tail_src"].shape[0], cap=cap,
                      max_steps=step + 2, device="cpu")
    st.front.copy_(_t(front))
    st.visited.copy_(_t(visited))
    st.pos.copy_(_t(pos.astype(np.int32)))
    f = st.front[st.front != SENTINEL]
    fq, fv = f >> st.vbits, f & ((1 << st.vbits) - 1)
    hub = False
    if st.fbits is not None:
        h = ix.t["is_hub"][fv.long()]
        or_bits(st.fbits, fq[h], fv[h] >> 5, _bit(fv[h]))
        hub = bool(h.any())
    ff._put(st.ctl, {ff.RUN: 1, ff.N_FRONT: cap, ff.HUB: hub,
                     ff.STEP: step, ff.LOG_N: 0})
    return st


def run_steps(ix, cs, ct, pad, cap):
    """Steps the reference and the port from the same states until the
    reference stops; asserts each step equal and returns what each step
    showed (raw, hub, answered mid-step, slot cap live)."""
    q = cs.shape[0]
    vbits = key_bits(ix.p.n)
    qi = np.arange(q, dtype=np.int32)
    front = np.full(cap, SENTINEL, np.int32)
    front[:q] = np.where(pad, SENTINEL, (qi << vbits) | cs)
    visited = np.zeros((q, (ix.p.n + 31) // 32), np.uint32)
    np.add.at(visited, (qi[~pad], cs[~pad] >> 5),
              np.uint32(1) << (cs[~pad] & 31).astype(np.uint32))
    pos = np.zeros(q, bool)
    seen = []
    for step in range(ix.p.n):
        if not (front != SENTINEL).any():
            break
        want = ref_step(ix, front, visited, pos, ct, cap)
        st = port_state(ix, front, visited, pos, cap, step)
        ff.expand_probe_plain(st, ix.t["ell"], ix.t["tail_src"],
                              ix.t["tail_dst"])
        assert int(st.ctl[ff.RAW]) == want["raw"]
        np.testing.assert_array_equal(st.slots.numpy(), want["slots"])
        meta, slab = ix.meta, ix.slab
        ff.dedup_classify_emit_plain(
            st, _t(ct), ix.t["is_hub"],
            fetch_rows=lambda c, t: (meta[c.long()], meta[t.long()],
                                     slab[c.long()]),
            classify=ff.classify_emit_plain)
        ctl = st.ctl.tolist()
        np.testing.assert_array_equal(st.pos.numpy() != 0, want["pos"])
        np.testing.assert_array_equal(st.visited.numpy(),
                                      want["visited"].view(np.int32))
        live = want["front"][want["front"] != SENTINEL]
        np.testing.assert_array_equal(st.front[:ctl[ff.N_FRONT]].numpy(),
                                      live)
        assert bool(ctl[ff.OVF]) == want["overflow"]
        assert ctl[ff.STEP] == step + 1
        m = int((want["uniq"][:cap] != SENTINEL).sum())
        np.testing.assert_array_equal(st.log[:ctl[ff.LOG_N]].numpy(),
                                      want["uniq"][:m])
        # the next front's hub bits, and nothing else, are set
        want_bits = np.zeros_like(visited)
        lq, lv = live >> vbits, live & ((1 << vbits) - 1)
        h = ix.np["is_hub"][lv]
        np.add.at(want_bits, (lq[h], lv[h] >> 5),
                  np.uint32(1) << (lv[h] & 31).astype(np.uint32))
        if st.fbits is not None:
            np.testing.assert_array_equal(st.fbits.numpy(),
                                          want_bits.view(np.int32))
        assert ctl[ff.HUB] == int(h.any())
        answered = want["pos"] & ~pos
        fk = want["fkey"][want["fkey"] != SENTINEL]
        seen.append(dict(
            raw=want["raw"], hub=want["hub"],
            slot_cap=bool(want["uniq"][cap] != SENTINEL),
            mid_step=bool(answered[fk >> vbits].any())))
        front, visited, pos = want["front"], want["visited"], want["pos"]
        if want["overflow"]:
            break
    return seen


RANDOM = lambda m: m.random_dag(300, 2.0, seed=0)                # noqa: E731
LAYERED = lambda m: m.layered_dag(500, 20, 3.0, seed=3)          # noqa: E731
LAYERED_TAIL = lambda m: m.layered_dag(400, 16, 3.0, seed=4)     # noqa: E731


@functools.lru_cache(maxsize=None)
def _index(name):
    graph, k, variant, width = {
        "random": (RANDOM, 2, "G", None),
        "layered": (LAYERED, 1, "L", None),
        "tail": (LAYERED_TAIL, 1, "L", 2)}[name]
    return Index(graph, k, variant, width)


def test_step_raw_over_cap_plus_one():
    """A small cap: the raw survivor count passes cap + 1 (the kept set is
    the first cap + 1 survivors in candidate order)."""
    ix = _index("layered")
    cs, ct = ix.queries(200, 56, seed=9)
    seen = run_steps(ix, cs, ct, np.zeros(cs.size, bool), 320)
    assert any(s["raw"] > 321 for s in seen)


def test_step_slot_cap_live():
    """raw == cap + 1 distinct survivors: only the live key in slot cap
    raises the overflow flag. At the first step each query's candidates
    are its source's distinct out-neighbours, so raw counts distinct keys;
    the cap is set one below it."""
    ix = _index("layered")
    cs, ct = ix.queries(200, 56, seed=9)
    pad = np.zeros(cs.size, bool)
    raw = run_steps(ix, cs, ct, pad, 4096)[0]["raw"]
    assert raw - 1 >= cs.size
    seen = run_steps(ix, cs, ct, pad, raw - 1)
    assert seen[0]["raw"] == raw and seen[0]["slot_cap"]
    assert len(seen) == 1


def test_step_tail_sweep():
    """ELL width 2: hubs reach the front and the COO tail is swept, gated
    by the frontier bitset the previous step set."""
    ix = _index("tail")
    assert ix.np["tail_src"].size > 0
    cs, ct = ix.queries(200, 56, seed=9)
    seen = run_steps(ix, cs, ct, np.zeros(cs.size, bool), 4096)
    assert sum(s["hub"] for s in seen) >= 2


@pytest.mark.parametrize("block", [1, 3 * 257])
def test_step_tail_sweep_in_blocks(block, monkeypatch):
    """The plain tail sweep cut into blocks of one query and of a few
    (``TAIL_BLOCK``, which bounds its memory at large q x m_t) steps as
    the reference does."""
    monkeypatch.setattr(ff, "TAIL_BLOCK", block)
    test_step_tail_sweep()


def test_step_padded_queries():
    ix = _index("tail")
    cs, ct = ix.queries(200, 56, seed=5)
    pad = np.zeros(cs.size, bool)
    pad[::3] = True
    seen = run_steps(ix, cs, ct, pad, 4096)
    assert len(seen) >= 2


def test_step_all_sentinel_front():
    """A front of SENTINEL only: no candidate, nothing changes, an empty
    next front."""
    ix = _index("tail")
    cs, ct = ix.queries(60, 4, seed=5)
    cap = 256
    front = np.full(cap, SENTINEL, np.int32)
    q = cs.size
    want = ref_step(ix, front, np.zeros((q, (ix.p.n + 31) // 32), np.uint32),
                    np.zeros(q, bool), ct, cap)
    st = port_state(ix, front, np.zeros((q, (ix.p.n + 31) // 32), np.uint32),
                    np.zeros(q, bool), cap, 0)
    ff.expand_probe_plain(st, ix.t["ell"], ix.t["tail_src"],
                          ix.t["tail_dst"])
    ff.dedup_classify_emit(st, dict(ct=_t(ct), meta=ix.meta, slab=ix.slab,
                                    is_hub=ix.t["is_hub"]))
    assert want["raw"] == 0 and int(st.ctl[ff.RAW]) == 0
    assert (want["front"] == SENTINEL).all()
    ctl = st.ctl.tolist()
    assert ctl[ff.N_FRONT] == 0 and ctl[ff.RUN] == 0 and ctl[ff.OVF] == 0
    assert not st.visited.any() and not st.pos.any()


def test_step_query_answered_mid_step():
    """A query proved positive in a step drops the UNKNOWN keys it emitted
    in that same step from the next front."""
    ix = _index("random")
    cs, ct = ix.queries(256, 64, seed=9)
    seen = run_steps(ix, cs, ct, np.zeros(cs.size, bool), 4096)
    assert any(s["mid_step"] for s in seen)


@pytest.mark.parametrize("name,max_steps", [("tail", 1), ("layered", 2),
                                             ("random", 3)])
def test_loop_stops_at_max_steps(name, max_steps):
    """A step budget below the BFS depth: the loop stops after max_steps
    steps with the reference's pos and overflow."""
    from repro.kernels.frontier_fused import \
        expand_frontier_fused as ref_expand_fused
    from repro_torch.kernels import ops
    ix = _index(name)
    cs, ct = ix.queries(200, 56, seed=4)
    pad = np.zeros(cs.size, bool)
    layout = [ix.t[k] for k in ("ell", "tail_src", "tail_dst", "is_hub")]
    ff.STEPS.reset()
    got = ops.expand_frontier(dict(meta=ix.meta, slab=ix.slab), *layout,
                              _t(cs), _t(ct), _t(pad), max_steps=max_steps,
                              cap=4096)
    assert ff.STEPS["steps"] == max_steps
    want = ref_expand_fused(ix.dev_ref, *(jnp.asarray(ix.np[k]) for k in (
        "ell", "tail_src", "tail_dst", "is_hub")), jnp.asarray(cs),
        jnp.asarray(ct), jnp.asarray(pad), max_steps=max_steps, cap=4096,
        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == bool(want[1])


@pytest.mark.parametrize("name,cap", [("tail", 4096), ("layered", 512)])
def test_loop_setup_and_cleanup_plain(name, cap):
    """The plain loop's set-up, steps and clean-up: after clean-up the
    visited and frontier bitsets are zero again, and pos equals the
    reference's fused loop."""
    from repro.kernels.frontier_fused import \
        expand_frontier_fused as ref_expand_fused
    ix = _index(name)
    cs, ct = ix.queries(200, 56, seed=3)
    pad = np.zeros(cs.size, bool)
    pad[::7] = True
    st = ff.StepState(q=cs.size, n_nodes=ix.p.n, w=ix.np["ell"].shape[1],
                      m_t=ix.np["tail_src"].shape[0], cap=cap,
                      max_steps=ix.p.n, device="cpu")
    tables = dict(ix.t, ct=_t(ct), meta=ix.meta, slab=ix.slab)
    ff.frontier_setup(st, _t(cs), _t(pad), ix.t["is_hub"], tables)
    while st.ctl[ff.RUN]:
        ff.expand_probe(st, tables)
        ff.dedup_classify_emit(st, tables)
    ovf = bool(st.ctl[ff.OVF])
    pos = st.pos.numpy() != 0
    ff.frontier_cleanup(st, tables)
    assert not st.visited.any()
    assert st.fbits is None or not st.fbits.any()
    want = ref_expand_fused(ix.dev_ref, *(jnp.asarray(ix.np[k]) for k in (
        "ell", "tail_src", "tail_dst", "is_hub")), jnp.asarray(cs),
        jnp.asarray(ct), jnp.asarray(pad), max_steps=ix.p.n, cap=cap,
        interpret=True)
    np.testing.assert_array_equal(pos, np.asarray(want[0]))
    assert ovf == bool(want[1])
