"""The static engine's decode state with request extras, on the CPU, as
``tests/test_torch_static_graphs.py`` holds it without: whisper-base's
frame buffer and internvl2-1b's prefix buffer (``DecodeState.extras``)
and the absolute block start keep their addresses across warmup,
generate and a second generate, for each of the six decoders (internvl2's
``cdlm`` on the paged layout too); every step the engine would capture
reads nothing from the host, so the graphs replay the batch's extras from
those buffers; a batch after another decodes as a fresh engine does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_extras import (  # noqa: E402
    INTERNVL,
    WHISPER,
    configs,
    extras,
    rows,
)
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from test_torch_static_graphs import (  # noqa: E402
    CAPTURED,
    THRESHOLD,
    _addresses,
    _no_host_reads,
    _outputs,
)

torch.set_num_threads(2)

P, G, B = 8, 8, 4
ENGINES = ([(WHISPER, n, "dense") for n in SAMPLERS]
           + [(INTERNVL, n, "dense") for n in SAMPLERS]
           + [(INTERNVL, "cdlm", "paged")])
IDS = [f"{c}-{n}-{lay}" for c, n, lay in ENGINES]


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in (WHISPER, INTERNVL):
        _, cfg = configs(name)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p["embed"]["head"] *= 4.0
        p["embed"]["head"][cfg.mask_token_id] = 0.0
        out[name] = (cfg, p)
    return out


def _engine(cfg, params, name, layout):
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, cache_refresh_interval=2,
                        sampler=name, cache_layout=layout, fused_select=True)
    return Engine(params, cfg, serve, prompt_len=P,
                  pos_offset=cfg.n_prefix_embeds, device="cpu")


def _trace(cfg, n=3, seed=0):
    prompts = np.random.default_rng(seed).integers(2, cfg.vocab_size - 1,
                                                   (n, P))
    ex = extras(cfg, n, seed=seed)
    return [Request(prompt=p, id=i, extras=rows(ex, i))
            for i, p in enumerate(prompts)]


def _all_addresses(eng):
    out = _addresses(eng)
    out["astart"] = eng._state.astart.data_ptr()
    out.update({f"extras.{k}": v.data_ptr()
                for k, v in eng._state.extras.items()})
    return out


@pytest.mark.parametrize("config,name,layout", ENGINES, ids=IDS)
def test_extras_buffers_keep_their_addresses(models, config, name, layout):
    cfg, params = models[config]
    eng = _engine(cfg, params, name, layout)
    assert sorted(eng._state.extras) == (["encoder_embeds"]
                                         if config == WHISPER
                                         else ["prefix_embeds"])
    want = _all_addresses(eng)
    eng.warmup()
    assert _all_addresses(eng) == want
    first = _outputs(eng.generate(_trace(cfg)))
    assert _all_addresses(eng) == want
    assert _outputs(eng.generate(_trace(cfg))) == first
    assert _all_addresses(eng) == want


@pytest.mark.parametrize("config,name,layout", ENGINES, ids=IDS)
def test_captured_steps_read_nothing_from_the_host(models, config, name,
                                                   layout, monkeypatch):
    cfg, params = models[config]
    eng = _engine(cfg, params, name, layout)
    seen = []

    def hook(step, fn):
        seen.append(step)
        with _no_host_reads(monkeypatch):
            return fn()

    eng._replay = hook
    outs = eng.generate(_trace(cfg))
    assert sorted(o.id for o in outs) == [0, 1, 2]
    want = set(CAPTURED[name]) | ({"greedy"} if name in THRESHOLD else set())
    assert set(seen) == want
    for o in outs:
        assert not np.any(o.tokens[:o.gen_length] == cfg.mask_token_id)


@pytest.mark.parametrize("config", [WHISPER, INTERNVL])
def test_a_batch_after_another_decodes_as_fresh(models, config):
    """The second batch's extras replace the first's in the buffers: its
    tokens equal a fresh engine's, and differ from those of the same
    prompts with the first batch's extras."""
    cfg, params = models[config]
    eng = _engine(cfg, params, "cdlm", "dense")
    first, second = _trace(cfg, n=2, seed=1), _trace(cfg, n=2, seed=2)
    eng.generate(first)
    got = _outputs(eng.generate(second))
    fresh = _outputs(_engine(cfg, params, "cdlm", "dense").generate(second))
    assert got == fresh
    swapped = [Request(prompt=s.prompt, id=s.id, extras=f.extras)
               for s, f in zip(second, first)]
    assert _outputs(eng.generate(swapped)) != got
