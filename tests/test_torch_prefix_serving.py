"""internvl2-1b through the port's static ``Engine`` against the JAX
engine, each request carrying its prefix
(``GenerationRequest.extras["prefix_embeds"]``, ``pos_offset`` 8 rows),
at ``reduced()`` fp32: the six decoders greedy (fused select; ``cdlm`` on
the dense and the paged layout), and a batch with sampled requests on the
per-lane path. Tokens, steps, generation lengths and finish reasons
exactly. Also the reference's refusals in its words: request extras in
the continuous engine (at ``add_request`` and ``warmup``), and a prefix
(``pos_offset``) for the continuous scheduler in ``make_engine``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_extras import (  # noqa: E402
    INTERNVL,
    check_static_engine,
    extras,
    requests,
    setup,
)
from _torch_recurrent import DECODERS, serve  # noqa: E402
from repro_torch.configs import ServeConfig  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Request,
    make_engine,
)

torch.set_num_threads(2)

REFUSED = "ContinuousEngine does not support request extras"


@pytest.fixture(scope="module")
def s():
    return setup(INTERNVL)


@pytest.mark.parametrize("name", DECODERS)
def test_static_engine(s, name):
    check_static_engine(s, name, layouts=(("dense", "paged")
                                          if name == "cdlm" else ("dense",)))


def test_static_engine_per_lane_sampled(s):
    check_static_engine(s, "cdlm", sampled=(0, 3), layouts=("dense",
                                                             "paged"))


def test_continuous_engine_refuses_extras(s):
    eng = ContinuousEngine(s.params, s.cfg,
                           serve(ServeConfig, scheduler="continuous"),
                           prompt_len=8, device="cpu")
    with pytest.raises(ValueError, match=REFUSED):
        eng.add_request(requests(s.cfg, Request, n=1)[0])
    with pytest.raises(ValueError, match=REFUSED):
        eng.warmup(extras={"prefix_embeds": extras(s.cfg, 2)[
            "prefix_embeds"]})
    assert not eng.has_unfinished()


def test_make_engine_refuses_a_prefix_for_the_continuous_scheduler(s):
    with pytest.raises(ValueError, match=r"ContinuousEngine does not "
                       r"support prefix embeds \(pos_offset != 0\) yet"):
        make_engine(s.params, s.cfg,
                    serve(ServeConfig, scheduler="continuous"),
                    prompt_len=8, pos_offset=8, device="cpu")
    eng = make_engine(s.params, s.cfg, serve(ServeConfig, scheduler="static"),
                      prompt_len=8, pos_offset=8, device="cpu")
    assert eng.spec.pos_offset == 8 and eng.spec.full_prompt_len == 16
    out = eng.generate([Request(prompt=np.arange(2, 10), extras={
        "prefix_embeds": extras(s.cfg, 1)["prefix_embeds"][0]})])
    assert len(out) == 1 and out[0].gen_length >= 0
