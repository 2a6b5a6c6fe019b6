"""whisper-base through the port's static ``Engine`` against the JAX
engine, each request carrying its frame embeddings
(``GenerationRequest.extras["encoder_embeds"]``), at ``reduced()`` fp32:
the six decoders greedy (fused select), and a batch with sampled requests
on the per-lane path. Tokens, steps, generation lengths and finish
reasons exactly. Also the reference's refusals: a batch whose requests
carry different extras keys (raised before the batch leaves the queue),
and request extras in the continuous engine."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_extras import (  # noqa: E402
    WHISPER,
    check_static_engine,
    extras,
    requests,
    setup,
)
from _torch_recurrent import DECODERS, serve  # noqa: E402
from repro_torch.configs import ServeConfig  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def s():
    return setup(WHISPER)


@pytest.mark.parametrize("name", DECODERS)
def test_static_engine(s, name):
    check_static_engine(s, name)


def test_static_engine_per_lane_sampled(s):
    check_static_engine(s, "cdlm", sampled=(1, 2))


def test_mismatched_extras_are_refused_before_the_batch_is_taken(s):
    """The reference's ``_validate_requests``: a batch whose requests carry
    different extras keys raises, and its requests stay queued."""
    eng = Engine(s.params, s.cfg, serve(ServeConfig, sampler="cdlm"),
                 prompt_len=8, device="cpu")
    reqs = requests(s.cfg, Request, n=2)
    eng.add_request(reqs[0])
    eng.add_request(dataclasses.replace(reqs[1], extras=None))
    with pytest.raises(ValueError, match="all requests in a batch must "
                       "carry the same extras keys"):
        eng.step()
    assert eng.has_unfinished() and len(eng._queue) == 2


def test_frames_of_the_wrong_shape_are_refused(s):
    eng = Engine(s.params, s.cfg, serve(ServeConfig, sampler="cdlm"),
                 prompt_len=8, device="cpu")
    ex = extras(s.cfg, 1)["encoder_embeds"][0, :5]
    eng.add_request(Request(prompt=np.arange(2, 10), extras={
        "encoder_embeds": ex}))
    with pytest.raises(ValueError, match="encoder_embeds of shape"):
        eng.step()
