"""The closed-loop generator: a seed gives the same stream; every seed
serves the same caps and modes in the same order, with its own prompts
and sampling seeds."""
import collections
import json

import numpy as np
import pytest

import rehearsal as R

R.paths()
from harness import traffic as TF  # noqa: E402

# a mix with several caps and modes, so that the order of a deck shows
MIX = dict(json.loads((R.REPO / "bench" / "mixes" / "batch-greedy.json")
                      .read_text()),
           caps={"blocks": [1, 2, 3, 8], "counts": [6, 3, 2, 1]},
           modes=[{"temperature": 0.0, "count": 1},
                  {"temperature": 0.7, "count": 1}])


def stream(seed, vocab=1000, special=(998, 3)):
    return TF.ClosedLoop(MIX, vocab_size=vocab, special_ids=special,
                         block_size=32, seed=seed)


def take(s, n):
    return [s.next() for _ in range(n)]


def test_same_seed_same_stream():
    a, b = take(stream(2**31 + 5), 50), take(stream(2**31 + 5), 50)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_tokens, x.temperature, x.seed) == (y.max_tokens,
                                                         y.temperature, y.seed)


def test_other_seed_same_work_other_prompts():
    n = sum(MIX["caps"]["counts"]) * sum(m["count"] for m in MIX["modes"])
    a, b = take(stream(1), 2 * n), take(stream(2), 2 * n)
    key = lambda r: (r.max_tokens, r.temperature)  # noqa: E731
    assert [key(r) for r in a] == [key(r) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    assert a[0].seed != b[0].seed
    # each deck holds every cap its count times, crossed with the modes,
    # and the second deck is in another order
    caps = collections.Counter(r.max_tokens // 32 for r in a[:n])
    assert [caps[k] for k in MIX["caps"]["blocks"]] == [
        2 * c for c in MIX["caps"]["counts"]]
    assert [key(r) for r in a[:n]] != [key(r) for r in a[n:]]


@pytest.mark.parametrize("seed", [0, 17, 2**31 + 11])
def test_prompts_avoid_the_special_ids(seed):
    reqs = take(stream(seed, vocab=6, special=(0, 5)), 20)
    ids = np.concatenate([r.prompt for r in reqs])
    assert set(ids.tolist()) == {1, 2, 3, 4}
    assert all(len(r.prompt) == MIX["prompt_len"] for r in reqs)
