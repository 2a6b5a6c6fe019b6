"""Deterministic host-side data pipeline, a copy of the JAX package's
``data/loader.py``: a pre-generated corpus of (prompt, answer) pairs served
as epochs of shuffled batches (the offline-dataset structure of paper
App. A.1 at toy scale). The same seeds give the same batches as the JAX
package's ``Corpus``."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import TaskSpec, sample_batch


class Corpus:
    def __init__(self, spec: TaskSpec, n_examples: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        data = sample_batch(rng, spec, n_examples)
        self.spec = spec
        self.prompt = data["prompt"]
        self.answer = data["answer"]
        self.n = n_examples

    def batches(self, batch_size: int, *, seed: int = 0,
                epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(self.n)
            for i in range(0, self.n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                yield {"prompt": self.prompt[idx], "answer": self.answer[idx]}

    def eval_batch(self, n: int) -> Dict[str, np.ndarray]:
        return {"prompt": self.prompt[:n], "answer": self.answer[:n]}
