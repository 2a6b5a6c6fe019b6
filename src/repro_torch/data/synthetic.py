"""Synthetic reasoning corpora, a copy of the JAX package's
``data/synthetic.py`` (what training and the Tables 1-2 bench need of
it).

- ``sort``: prompt = <SORT> x_1..x_k <ASK>, answer = sorted(x) <EOS>.
- ``add``:  prompt = <ADD> digits(a) <PLUS> digits(b) <ASK>,
  answer = digits(a+b) <EOS>.

Token space: digits 0..9 are ids 10..19; sort values are ids
10..(10+range); ids below 10 are specials.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

PAD, EOS, ASK, PLUS, SORT_TAG, ADD_TAG = 0, 1, 2, 3, 4, 5
SPECIALS = 10  # ids < 10 reserved
DIGIT0 = 10    # digit d -> DIGIT0 + d


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str                  # sort | add
    vocab_size: int            # must match ModelConfig.vocab_size
    prompt_len: int = 16
    gen_len: int = 16
    sort_k: int = 8            # numbers to sort
    sort_range: int = 64       # values in [0, sort_range)
    add_digits: int = 5        # digits per operand

    def __post_init__(self):
        if self.name == "sort":
            ok = (SPECIALS + self.sort_range < self.vocab_size - 1
                  and self.sort_k + 2 <= self.prompt_len
                  and self.sort_k + 1 <= self.gen_len)
        else:
            ok = (2 * self.add_digits + 3 <= self.prompt_len
                  and self.add_digits + 2 <= self.gen_len)
        if not ok:
            raise ValueError(f"task {self} does not fit its vocabulary, "
                             "prompt or generation length")


def _pad(arr, length):
    out = np.full((len(arr), length), PAD, np.int32)
    for i, row in enumerate(arr):
        out[i, :len(row)] = row
    return out


def sample_batch(rng: np.random.Generator, spec: TaskSpec,
                 batch: int) -> Dict[str, np.ndarray]:
    """Returns {"prompt": (b, P), "answer": (b, G)} (answer EOS-terminated,
    PAD-padded)."""
    prompts, answers = [], []
    if spec.name == "sort":
        for _ in range(batch):
            xs = rng.integers(0, spec.sort_range, spec.sort_k)
            prompts.append([SORT_TAG] + [DIGIT0 + int(v) for v in xs] + [ASK])
            answers.append([DIGIT0 + int(v) for v in sorted(xs)] + [EOS])
    elif spec.name == "add":
        hi = 10 ** spec.add_digits
        for _ in range(batch):
            a, b = int(rng.integers(0, hi)), int(rng.integers(0, hi))
            da = [DIGIT0 + int(c) for c in str(a)]
            db = [DIGIT0 + int(c) for c in str(b)]
            prompts.append([ADD_TAG] + da + [PLUS] + db + [ASK])
            answers.append([DIGIT0 + int(c) for c in str(a + b)] + [EOS])
    else:
        raise ValueError(spec.name)
    return {"prompt": _pad(prompts, spec.prompt_len),
            "answer": _pad(answers, spec.gen_len)}


def verify(prompt_row: np.ndarray, gen_row: np.ndarray,
           spec: TaskSpec) -> bool:
    """Exact-match scorer (the Tables 1-2 'Score' column at toy scale): the
    generation up to its first EOS equals the sorted values or the sum's
    digits."""
    gen = list(gen_row)
    ans = gen[:gen.index(EOS)] if EOS in gen else gen
    p = list(prompt_row)
    try:
        if spec.name == "sort":
            want = sorted(p[p.index(SORT_TAG) + 1:p.index(ASK)])
        else:
            plus, ask = p.index(PLUS), p.index(ASK)
            a = int("".join(str(t - DIGIT0)
                            for t in p[p.index(ADD_TAG) + 1:plus]))
            b = int("".join(str(t - DIGIT0) for t in p[plus + 1:ask]))
            want = [DIGIT0 + int(c) for c in str(a + b)]
    except (ValueError, IndexError):
        return False
    return ans == want


def score(prompts: np.ndarray, tokens: np.ndarray, prompt_len: int,
          spec: TaskSpec) -> float:
    """The share of rows whose generation (``tokens[:, prompt_len:]``)
    :func:`verify` accepts."""
    gens = np.asarray(tokens)[:, prompt_len:]
    return float(np.mean([verify(p, g, spec)
                          for p, g in zip(np.asarray(prompts), gens)]))


def answer_mask(answers: np.ndarray) -> np.ndarray:
    """Maskable positions for the DLM loss: everything up to and including
    EOS (PAD tail excluded)."""
    b, g = answers.shape
    is_eos = answers == EOS
    has = is_eos.any(axis=1)
    first = np.where(has, is_eos.argmax(axis=1), g - 1)
    idx = np.arange(g)[None, :]
    return idx <= first[:, None]
