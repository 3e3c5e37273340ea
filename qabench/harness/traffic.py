"""The one generator of traffic: the order in which a closed-loop client
asks for a mix's metric sets, drawn from the seed.

A mix file names its metric ``sets``. Requests come in rounds of
``len(sets)``, each round every set once, in an order drawn from the seed:
each set is drawn uniformly, and every seed asks for the same work in
another order, so the seed does not change a window's mix. A set listed
twice is asked for twice as often.

A closed loop with ``clients`` clients (one, in every mix so far): a
client's next request waits for its last report.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def metric_sets(mix: dict) -> list[tuple[str, ...]]:
    return [tuple(s) for s in mix["sets"]]


def order(mix: dict, seed: int) -> Iterator[int]:
    """The index into ``metric_sets(mix)`` of each request, endlessly."""
    if mix.get("order", "rounds") != "rounds" or mix.get("clients", 1) != 1:
        raise ValueError("the generator takes closed-loop mixes of one "
                         "client with order 'rounds'")
    rng = np.random.default_rng(int(seed))
    k = len(mix["sets"])
    while True:
        yield from (int(i) for i in rng.permutation(k))
