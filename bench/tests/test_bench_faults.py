"""The check fails a run whose timed path is broken underneath: the
harness's look for a card is skipped (the CPU, at a reduced size), the
rest of a run is driven as on the card, and ``correct`` comes out false
for each fault a serving cell can have. (The cells run on one card, so
there is no exchange between cards to leave out.)"""
import pytest
import torch

import rehearsal as R

R.paths()
from repro_torch.core import diffusion as D  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

CELLS = ["dream7b-batch-greedy", "dream7b-single-greedy"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return R.make_root(tmp_path_factory.mktemp("faults"))


def _alter_token(monkeypatch):
    """A candidate changed where it is produced: every lane's first
    position takes the next token id."""
    for name in ("confidence_and_candidates_fused",
                 "confidence_and_candidates",
                 "confidence_and_candidates_per_lane"):
        orig = getattr(D, name)

        def wrapped(*a, _orig=orig, **k):
            cand, conf = _orig(*a, **k)
            cand = cand.clone()
            cand[..., 0] = (cand[..., 0] + 1) % 500
            return cand, conf
        monkeypatch.setattr(D, name, wrapped)


def _state_unchanged(monkeypatch):
    """A refinement iteration that returns the canvases unchanged."""
    monkeypatch.setattr(E.ContinuousEngine, "_refine",
                        lambda self, variant=None: None)


def _half_batch(monkeypatch):
    """The cached forward leaves out the second half of the lanes."""
    orig = E.lane_block_forward

    def wrapped(*a, **k):
        out, em = orig(*a, **k)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, em
    monkeypatch.setattr(E, "lane_block_forward", wrapped)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    assert R.run(root, cell, seconds=0.5)["correct"]


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged,
                                   _half_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    torch.manual_seed(0)
    # long enough that each lane finishes a greedy request to judge
    res = R.run(root, cell, seconds=2.0)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_mix_that_samples_is_refused(root):
    """Only greedy requests can be judged, so no cell may sample."""
    import json
    R.paths()
    from harness import cell as CL
    from harness import spec as SP
    mix = json.loads(json.dumps(SP.load_cell(root, CELLS[0]).mix))
    mix["modes"].append({"temperature": 0.7, "count": 1})
    with pytest.raises(ValueError, match="greedy"):
        CL.run_cell(root, CELLS[0], seed=1, seconds=0.1, trace=False,
                    device="cpu", t_start=0.0, mix=mix)


def test_lanes_with_alike_blocks_are_told_apart_by_their_prompts():
    """Two lanes can end a step holding alike blocks at one index (both
    repeating a token); the judged lane is the one with the request's
    prompt, whose block changed during the step."""
    import numpy as np
    from types import SimpleNamespace

    from harness import check as CK
    P, B, mask = 3, 2, 9
    # lane 0 finished its block earlier: [7, 7]; lane 1 decodes [7, 7] now
    canvases = np.array([[[1, 2, 3, 7, 7], [4, 5, 6, 7, mask]],
                         [[1, 2, 3, 7, 7], [4, 5, 6, 7, 7]]])

    class Rec:
        def host(self, lo, hi, cols):
            return canvases[lo:hi][:, :, cols]

    st = SimpleNamespace(it0=0, it1=2)
    toks = np.array([7, 7])
    assert CK._lane(Rec(), st, 0, toks, np.array([4, 5, 6])) == 1
    assert CK._lane(Rec(), st, 0, toks, np.array([1, 2, 3])) == 0
    win = SimpleNamespace(steps=[SimpleNamespace(it0=0, it1=2, events=[
        (11, 0, toks)])], specs={11: SimpleNamespace(prompt=np.array(
            [4, 5, 6]))})
    got = CK.collect(win, Rec(), {11: None}, prompt_len=P,
                     mask_id=mask)[0]
    assert got["states"].tolist() == [[mask, mask], [7, mask]]
    assert got["after"].tolist() == [[7, mask], [7, 7]]


def test_the_sample_judges_every_lane_and_the_longest_whole():
    """Of requests on four lanes: the longest whole, one block on each
    other lane, then whole requests up to the token floor."""
    import numpy as np
    from types import SimpleNamespace

    from harness import check as CK
    P, B = 2, 2
    prompts = {r: np.array([10 * r, 10 * r + 1]) for r in range(6)}
    lane_of = {0: 0, 1: 1, 2: 2, 3: 3, 4: 1, 5: 2}
    nblocks = {0: 3, 1: 1, 2: 2, 3: 2, 4: 2, 5: 1}
    # one step a block; a request's blocks in its own steps
    steps, canv = [], []
    for r, n in nblocks.items():
        for b in range(n):
            c = np.zeros((4, P + 3 * B), np.int64)
            c[lane_of[r], :P] = prompts[r]
            c[lane_of[r], P:P + (b + 1) * B] = 5
            canv.append(c)
            steps.append(SimpleNamespace(it0=len(canv) - 1, it1=len(canv),
                                         events=[(r, b, np.array([5, 5]))]))

    class Rec:
        def host(self, lo, hi, cols):
            return np.stack(canv[lo:hi])[:, :, cols]

    win = SimpleNamespace(steps=steps, outputs=dict.fromkeys(nblocks),
                          specs={r: SimpleNamespace(prompt=prompts[r],
                                                    temperature=0.0)
                                 for r in nblocks})
    picks = CK.sample(win, Rec(), min_tokens=0, seed=3)
    assert picks[0] is None                      # the longest, whole
    lanes = {lane_of[r] for r in picks}
    assert lanes == {0, 1, 2, 3}
    assert all(len(v) == 1 and 0 <= v[0] < nblocks[r]
               for r, v in picks.items() if r != 0)
    whole = CK.sample(win, Rec(), min_tokens=10 ** 6, seed=3)
    assert set(whole) == set(nblocks) and all(v is None
                                             for v in whole.values())
