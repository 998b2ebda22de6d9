"""The one traffic generator: a mix file's parameters and a seed in, the
window's pairs out.

A mix is a JSON file under ``traffic/``. Its ``loop`` picks the shape:

* ``closed``: one client calling ``QuerySession.query`` back to back with
  ``pairs_per_call`` pairs a call, from a pool of ``pool_calls`` calls that
  the window goes through in turn (the session keeps no answers, so a pair
  met again costs what it did the first time).
* ``open``: requests of ``request_pairs`` pairs through ``Frontend``,
  round robin over ``tenants`` tenants, ``rate_per_s`` a second. Their
  arrival times are a Poisson process's, given its count: rate × window
  uniform times, sorted, so every seed offers the same load.

``kinds`` is a repeating pattern of blocks (a request, or ``block`` pairs
of a call): ``[["random", 15], ["walk", 1]]`` makes block i a walk block
when i % 16 == 15. Kinds: ``random`` (uniform s and t) and ``walk``
(forward walks of 1 to ``max_walk`` steps: reachable by construction).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import gen

# the seed's draws for the window, the warm-up and the sample never overlap
WINDOW, WARMUP, SAMPLE = 0, 1, 2


@dataclass
class Traffic:
    """Pairs in the order they are sent: ``s``, ``t`` int64, ``kind`` int8
    (the mix's index of each block's kind), and for an open loop each
    request's due time (s after the window opens) and tenant."""
    s: np.ndarray
    t: np.ndarray
    kind: np.ndarray
    block: int
    due: Optional[np.ndarray] = None
    tenant: Optional[np.ndarray] = None

    @property
    def n_blocks(self) -> int:
        return self.s.size // self.block


def _rng(seed: int, stream: int):
    return np.random.default_rng([seed, stream])


def kind_of_blocks(mix: dict, n_blocks: int) -> np.ndarray:
    pattern = np.concatenate([np.full(int(w), i, np.int8)
                              for i, (_, w) in enumerate(mix["kinds"])])
    return pattern[np.arange(n_blocks) % pattern.size]


def _pairs(graph, mix: dict, kinds: np.ndarray, block: int, rng):
    n, indptr, indices = graph
    q = kinds.size * block
    s = np.empty(q, np.int64)
    t = np.empty(q, np.int64)
    per_pair = np.repeat(kinds, block)
    for i, (name, _) in enumerate(mix["kinds"]):
        at = np.flatnonzero(per_pair == i)
        if not at.size:
            continue
        if name == "random":
            s[at], t[at] = gen.random_pairs(n, at.size, rng)
        elif name == "walk":
            s[at], t[at] = gen.walk_pairs(indptr, indices, at.size, rng,
                                          int(mix.get("max_walk", 32)))
        else:
            raise ValueError(f"unknown pair kind {name!r}")
    return s, t, per_pair


def block_size(mix: dict) -> int:
    return int(mix["request_pairs"] if mix["loop"] == "open"
               else mix["block"])


def window(graph, mix: dict, seed: int, seconds: float) -> Traffic:
    """The pairs the window sends: for ``closed`` the pool of calls, for
    ``open`` every request due within ``seconds``."""
    rng = _rng(seed, WINDOW)
    block = block_size(mix)
    if mix["loop"] == "closed":
        n_blocks = int(mix["pool_calls"]) * int(mix["pairs_per_call"]) // block
        kinds = kind_of_blocks(mix, n_blocks)
        s, t, kind = _pairs(graph, mix, kinds, block, rng)
        return Traffic(s, t, kind, block)
    if mix["loop"] != "open":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    n_req = int(round(float(mix["rate_per_s"]) * seconds))
    due = np.sort(rng.random(n_req)) * seconds
    kinds = kind_of_blocks(mix, n_req)
    s, t, kind = _pairs(graph, mix, kinds, block, rng)
    tenant = np.arange(n_req) % int(mix["tenants"])
    return Traffic(s, t, kind, block, due=due, tenant=tenant)


def warmup(graph, mix: dict, seed: int, n_pairs: int) -> Traffic:
    """``n_pairs`` pairs of the mix's kinds, drawn apart from the window's."""
    block = block_size(mix)
    kinds = kind_of_blocks(mix, max(1, n_pairs // block))
    s, t, kind = _pairs(graph, mix, kinds, block, _rng(seed, WARMUP))
    return Traffic(s, t, kind, block)


def sample_blocks(traffic: Traffic, mix: dict, seed: int) -> np.ndarray:
    """The blocks whose answers the check compares: ``sample_blocks`` of
    each kind (all of a kind where it has fewer), drawn from the seed."""
    rng = _rng(seed, SAMPLE)
    per_kind = int(mix["sample_blocks"])
    kinds = traffic.kind[::traffic.block]
    picked = []
    for i in range(len(mix["kinds"])):
        of_kind = np.flatnonzero(kinds == i)
        take = min(per_kind, of_kind.size)
        picked.append(rng.choice(of_kind, take, replace=False))
    return np.sort(np.concatenate(picked))
