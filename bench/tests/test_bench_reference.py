"""The plain reference against the program's own forward at a reduced
config, in float32 on the CPU: the logits of a block's states, each the
prompt, the committed blocks and the block as it stood, under the
block-causal mask. Both are imported here, never one in the other."""
import numpy as np
import pytest
import torch

import rehearsal as R

R.paths()
from harness import cell as CL  # noqa: E402
from harness import spec as SP  # noqa: E402
from harness import weights as WT  # noqa: E402

from repro_torch.core import masks  # noqa: E402
from repro_torch.models import forward  # noqa: E402


@pytest.mark.parametrize("config,kv,bias", [("dream-7b", 2, True),
                                            ("llada-8b", 4, False)])
def test_reference_matches_the_program_forward(config, kv, bias):
    model = SP._json(R.REPO / "bench" / "configs" / f"{config}.json")["model"]
    model.update(R.SMALL_MODEL, n_kv_heads=kv)
    assert model["qkv_bias"] == bias
    ref = SP.load_module(R.REPO, "reference", "dense_decoder")
    params = WT.draw(ref.layout(model), model, 3, torch.device("cpu"),
                     torch.float32)
    cfg = CL.model_config(model)
    rng = np.random.default_rng(0)
    P, B, mask = 12, 4, model["mask_token_id"]
    prompt = rng.integers(0, 500, P)
    blocks = rng.integers(0, 500, (3, B))
    states, sblk = [], []
    for b in range(3):
        for j in range(B):
            s = blocks[b].copy()
            s[j:] = mask
            states.append(s)
            sblk.append(b)
    states = np.stack(states)
    gather = states[..., None] % 500
    got = ref.block_stats(params, model, [{
        "prompt": prompt, "context": blocks[:2].reshape(-1), "states": states,
        "state_block": np.asarray(sblk)}], gather=[gather])[0]
    for i, (s, b) in enumerate(zip(states, sblk)):
        toks = np.concatenate([prompt, blocks[:b].reshape(-1), s])
        out = forward(params, torch.as_tensor(toks)[None], cfg=cfg,
                      device="cpu", mode=masks.BLOCK_CAUSAL, prompt_len=P,
                      block_size=B)
        lg = out.logits[0, -B:].double()
        np.testing.assert_allclose(got["max"][i], lg.max(-1).values,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["lse"][i], torch.logsumexp(lg, -1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got["gathered"][i, :, 0],
            lg.gather(1, torch.as_tensor(gather[i])).squeeze(1),
            rtol=1e-5, atol=1e-5)


def test_the_control_departs_from_the_reference():
    """The fp8 control computes other logits than the fp32 reference."""
    model = SP._json(R.REPO / "bench" / "configs" / "dream-7b.json")["model"]
    model.update(R.SMALL_MODEL, n_kv_heads=2)
    ref = SP.load_module(R.REPO, "reference", "dense_decoder")
    params = WT.draw(ref.layout(model), model, 4, torch.device("cpu"),
                     torch.float32)
    rng = np.random.default_rng(1)
    req = {"prompt": rng.integers(0, 500, 8), "context": np.zeros(0, int),
           "states": np.full((1, 4), model["mask_token_id"]),
           "state_block": np.zeros(1, int)}
    hi = ref.block_stats(params, model, [req])[0]
    lo = ref.block_stats(params, model, [req], precision="fp8")[0]
    assert np.abs(hi["max"] - lo["max"]).max() > 1e-3
