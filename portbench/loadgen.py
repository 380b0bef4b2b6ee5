"""The traffic of a cell, from its traffic file and ``--seed``.

A closed loop: ``clients`` users, each with its own queue of requests; a
client submits its next request once its previous one finished, as a chat
front end with a cap on concurrent requests does.

The sizes are the traffic file's, the same for every seed, so that two
runs do the same work: the k-th requests of the clients take the
log-normal's quantiles at ``clients`` evenly spaced probabilities,
clipped, shuffled over the clients by the file's ``schedule_seed``
(prompt and output lengths apart), so the requests in flight always hold
about one of each.  Each client's first request starts part-way through
its output (the share already done is evenly spaced over the clients,
then shuffled), which spreads completions over the window instead of
letting them come in waves.  ``--seed`` draws each request's prompt
tokens (and the weights).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    prompt_len: int
    max_new_tokens: int
    key: int            # the request's own stream of prompt tokens


def stratified_lengths(n: int, dist: dict) -> np.ndarray:
    """``n`` lengths at the log-normal's quantiles (i + 0.5) / n, clipped to
    ``[min, max]``: median ``median``, log-space spread ``sigma``."""
    nd = NormalDist()
    q = [(i + 0.5) / n for i in range(n)]
    x = [dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf(p)) for p in q]
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


class Traffic:
    """The requests of every client of one cell under one seed."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab_size = vocab_size
        self.clients = int(mix["clients"])
        per = int(mix["requests_per_client"])
        rng = np.random.default_rng(int(mix["schedule_seed"]))
        plens = stratified_lengths(self.clients, mix["prompt"])
        olens = stratified_lengths(self.clients, mix["output"])
        prompts = np.stack([rng.permutation(plens) for _ in range(per)], 1)
        outs = np.stack([rng.permutation(olens) for _ in range(per)], 1)
        done = (rng.permutation(self.clients) + 0.5) / self.clients
        self._full = outs.reshape(-1)
        self.queues: List[List[Spec]] = []
        for c in range(self.clients):
            q = []
            for k in range(per):
                i = c * per + k
                new = int(outs[c, k])
                if k == 0:
                    new = max(1, new - int(done[c] * new))
                q.append(Spec(int(prompts[c, k]), new, i))
            self.queues.append(q)
        self._next = [0] * self.clients

    def tokens(self, spec: Spec) -> np.ndarray:
        """The prompt of ``spec``, the same for the same seed."""
        rng = np.random.default_rng([self.seed, spec.key])
        return rng.integers(0, self.vocab_size, spec.prompt_len,
                            dtype=np.int64).astype(np.int32)

    def next(self, client: int) -> Spec:
        """The client's next request.  A client that ran through its queue
        starts it again from the top (its first request then whole)."""
        q = self._next[client]
        self._next[client] = q + 1
        queue = self.queues[client]
        spec = queue[q % len(queue)]
        if q >= len(queue) and q % len(queue) == 0:
            spec = dataclasses.replace(
                spec, max_new_tokens=int(self._full[spec.key]))
        return spec

    def longest_prompt(self) -> int:
        return max(s.prompt_len for q in self.queues for s in q)
