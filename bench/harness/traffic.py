"""The one traffic generator: a mix file's parameters and a seed give a
stream of requests, each client sending its next as soon as its last one
has finished (a closed loop).

A mix file (``bench/mixes/<name>.json``) gives:

- ``prompt_len``: tokens of every prompt (the engine serves one length);
- ``clients``: requests in flight or waiting at any time;
- ``caps``: ``{"blocks": [k, ...], "counts": [n_k, ...]}``: a request's
  cap is k blocks of the engine's ``block_size``, and every run of
  ``sum(counts)`` requests holds each cap ``n_k`` times;
- ``modes``: ``[{"temperature": t, "count": m}, ...]``: the same for the
  sampling temperature (0 greedy), crossed with the caps;
- ``order_seed``: the order of each run of caps and modes is drawn from
  it, not from the run's seed: in a closed loop the order sets which
  steps admit, so every seed serves the same work;
- ``engine``: the engine's settings (``cell.py``).

Prompts are token ids drawn from the run's seed over the whole vocabulary
but the mask and EOS ids; a sampled request carries a seed of its own,
drawn from the run's seed too.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class RequestSpec:
    index: int                # order of sending
    prompt: np.ndarray        # (prompt_len,) int64
    max_tokens: int
    temperature: float
    seed: int                 # the request's own stream (sampled requests)


def _deck(mix: dict) -> List[tuple]:
    caps, modes = mix["caps"], mix["modes"]
    if len(caps["blocks"]) != len(caps["counts"]):
        raise ValueError("caps: blocks and counts differ in length")
    deck = []
    for blocks, n in zip(caps["blocks"], caps["counts"]):
        for mode in modes:
            deck += [(int(blocks), float(mode["temperature"]))] * (
                int(n) * int(mode["count"]))
    if not deck:
        raise ValueError("the mix's deck of caps and modes is empty")
    return deck


class ClosedLoop:
    """The mix's requests in the order the clients send them."""

    def __init__(self, mix: dict, *, vocab_size: int, special_ids,
                 block_size: int, seed: int):
        self.mix = mix
        self.prompt_len = int(mix["prompt_len"])
        self.clients = int(mix["clients"])
        self.block_size = block_size
        self.vocab_size = vocab_size
        self.special = sorted(set(int(s) for s in special_ids))
        prompts, seeds = np.random.SeedSequence(int(seed)).spawn(2)
        self._prompts = np.random.default_rng(prompts)
        self._seeds = np.random.default_rng(seeds)
        self._order = np.random.default_rng(int(mix["order_seed"]))
        self._deck = _deck(mix)
        self._pending: List[tuple] = []
        self._sent = 0

    def _prompt(self) -> np.ndarray:
        """Ids over the vocabulary without the special ones: a draw over
        ``V - len(special)`` values, shifted past each special id."""
        u = self._prompts.integers(0, self.vocab_size - len(self.special),
                                   self.prompt_len, dtype=np.int64)
        for s in self.special:
            u = u + (u >= s)
        return u

    def next(self) -> RequestSpec:
        if not self._pending:
            perm = self._order.permutation(len(self._deck))
            self._pending = [self._deck[i] for i in perm]
        blocks, temperature = self._pending.pop(0)
        spec = RequestSpec(index=self._sent, prompt=self._prompt(),
                           max_tokens=blocks * self.block_size,
                           temperature=temperature,
                           seed=int(self._seeds.integers(0, 2**31 - 1)))
        self._sent += 1
        return spec
