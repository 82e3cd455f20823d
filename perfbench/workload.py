"""The traffic generator: one reader for every mix file under
``perfbench/traffic/``.

A mix is one request shape (``ii`` prompt tokens, ``oo`` new tokens, ``bb``
prompts a request) sent in a ``closed`` loop: one client, the next request
sent when the last one ends.  Prompt tokens are drawn uniform over the
vocabulary from the seed; every seed sees the same sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from perfbench.weights import seed64

STREAM_TRAFFIC, STREAM_WARM, STREAM_SAMPLE = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Shape:
    ii: int
    oo: int
    bb: int

    @property
    def max_len(self) -> int:
        return self.ii + self.oo


@dataclasses.dataclass
class Request:
    shape: Shape
    prompts: np.ndarray          # (bb, ii) int64


class Mix:
    def __init__(self, spec: dict, vocab: int, seed: int):
        if spec["loop"] != "closed" or spec.get("clients", 1) != 1:
            raise ValueError("the engine serves one client's batches in a "
                             "closed loop")
        if len(spec["requests"]) != 1:
            raise ValueError("the engine holds one decode graph: a mix has "
                             "one request shape")
        r = spec["requests"][0]
        self.shape = Shape(r["ii"], r["oo"], r["bb"])
        self.vocab = vocab
        self.seed = seed64(seed)

    def _request(self, rng) -> Request:
        sh = self.shape
        return Request(sh, rng.integers(0, self.vocab, (sh.bb, sh.ii),
                                        dtype=np.int64))

    def requests(self) -> Iterator[Request]:
        """The window's requests, in order, without end."""
        rng = np.random.default_rng([self.seed, STREAM_TRAFFIC])
        while True:
            yield self._request(rng)

    def warmup(self) -> Request:
        """A request of the mix's shape, from a stream of its own."""
        return self._request(np.random.default_rng([self.seed, STREAM_WARM]))

    def sample_rng(self):
        """The stream that draws the requests the check compares."""
        return np.random.default_rng([self.seed, STREAM_SAMPLE])
