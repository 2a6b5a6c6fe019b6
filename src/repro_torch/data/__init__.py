"""The synthetic task corpora of the JAX package's ``data/`` (numpy only),
copied so that the port imports nothing of it."""
from repro_torch.data.loader import Corpus  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    TaskSpec,
    answer_mask,
    sample_batch,
    score,
    verify,
)
