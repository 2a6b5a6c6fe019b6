"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the window finished
(the longest whole, a block of one on every other lane, more up to a
token count; ``sample``) is judged against the plain reference
(``bench/reference/``), which runs over the same prompts and the served
tokens. What is judged is what the timed path produced: every refinement
iteration of every judged block, as the engine's canvases after each
iteration
(``window.Recorder``) show it. Before an iteration the block holds some
mask tokens; the iteration finalizes one position or more. The
reference computes, from the prompt, the served blocks before and the
block as it stood, the logits at every position of the block, and the
run is held to two numbers:

- ``choice_gap``: the widest gap, in nats of the reference's
  distribution, by which a choice of the program lies below the
  reference's best: the larger of
  ``token_gap``, by which a finalized token's log-probability lies below
  the reference's largest at its position (the admission prefill and the
  commit pass, whose cache every later forward reads, the cached forward,
  the fused select or the dense logits), and ``order_gap``, by which the
  reference's confidence at a finalized position lies below its best
  among the block's masked positions unless it reaches the threshold tau,
  or a position left masked lies above log tau (the threshold rule). Each
  alone is logged; the control separates only their larger (``PERF.md``);
- ``unfinished``: mask tokens left in a served block.

Only greedy requests can be judged: of a sampled lane's draws the
canvases keep only the finalized one, which tells nothing of the draw's
distribution, so ``cell.run_cell`` refuses a mix that samples.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np


COMPARED = ("choice_gap", "unfinished")


def _events(win) -> Dict[int, List[tuple]]:
    out: Dict[int, List[tuple]] = {}
    for st in win.steps:
        for rid, b, toks in st.events:
            out.setdefault(rid, []).append((st, b, toks))
    return out


def _lane(recorder, st, b: int, toks, prompt) -> int:
    """The lane that decoded block ``b`` of the request with ``prompt`` in
    step ``st``: the one whose canvas, after the step's last iteration,
    holds that prompt (prompts are drawn apart, so one lane does) and the
    block as it was served. Matching the block alone is not enough: two
    lanes can hold alike blocks at one index, as when both repeat a
    token."""
    P, B = len(prompt), len(toks)
    last = recorder.host(st.it1 - 1, st.it1, slice(0, P + (b + 1) * B))[0]
    lanes = np.flatnonzero((last[:, :P] == prompt[None, :]).all(-1)
                           & (last[:, P + b * B:] == toks[None, :]).all(-1))
    if len(lanes) != 1:
        raise RuntimeError(f"block {b}: {len(lanes)} lanes hold the "
                           "request's prompt and served block")
    return int(lanes[0])


def sample(win, recorder, *, min_tokens: int,
           seed: int) -> Dict[int, Optional[List[int]]]:
    """The judged requests, of the finished greedy ones, each with the
    blocks judged (None: all): the longest, whole; then, on every other
    lane that served one, one block of one request, so that every lane's
    rows are judged (a fault in part of the batch shows) at the cost of a
    block a lane; then others, whole, until ``min_tokens`` judged tokens.
    Requests and blocks go by draws from the seed."""
    evs = _events(win)
    done = sorted(r for r in win.outputs if win.specs[r].temperature == 0)
    if not done:
        return {}
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(4)[3])
    order = [done[i] for i in rng.permutation(len(done))]
    blocks = {r: len(evs[r]) for r in done}
    width = len(evs[done[0]][0][2])
    lane = {r: _lane(recorder, *evs[r][0], win.specs[r].prompt)
            for r in done}
    first = max(order, key=lambda r: blocks[r])
    out: Dict[int, Optional[List[int]]] = {first: None}
    covered = {lane[first]}
    tokens = blocks[first] * width
    for r in order:
        if lane[r] not in covered:
            out[r] = [int(rng.integers(blocks[r]))]
            covered.add(lane[r])
            tokens += width
    for r in order:
        if tokens >= min_tokens:
            break
        if out.get(r, []) is not None:
            tokens += (blocks[r] - len(out.get(r, []))) * width
            out[r] = None
    return out


def collect(win, recorder, picks: Dict[int, Optional[List[int]]], *,
            prompt_len: int, mask_id: int) -> List[dict]:
    """Each judged request's prompt, served blocks and the states of its
    judged blocks before each iteration (``states``, ``state_block``)
    with the canvas after it (``after``)."""
    evs = _events(win)
    out = []
    for rid, judged in picks.items():
        blocks, states, after, sblk = [], [], [], []
        for st, b, toks in sorted(evs[rid], key=lambda e: e[1]):
            B = len(toks)
            blocks.append(np.asarray(toks))
            if judged is not None and b not in judged:
                continue
            cols = slice(prompt_len + b * B, prompt_len + (b + 1) * B)
            lane = _lane(recorder, st, b, toks, win.specs[rid].prompt)
            hist = recorder.host(st.it0, st.it1, cols)[:, lane]
            before = np.concatenate([np.full((1, B), mask_id, hist.dtype),
                                     hist[:-1]])
            states.append(before)
            after.append(hist)
            sblk += [b] * len(hist)
        out.append({"id": rid, "prompt": np.asarray(win.specs[rid].prompt),
                    "blocks": blocks,
                    "context": np.concatenate(blocks[:-1] or
                                              [np.zeros(0, np.int64)]),
                    "states": np.concatenate(states),
                    "after": np.concatenate(after),
                    "state_block": np.asarray(sblk, np.int64),
                    "judged_tokens": len(states) * blocks[0].size})
    return out


def _order_gaps(lc, before, after, mask_id, tau, chosen=None):
    """Per state: the finalized positions' shortfall from the best masked
    confidence (or from tau), and the masked positions' excess over tau.
    ``chosen`` (S, B) bool, where given, stands for the finalized
    positions (the control's)."""
    log_tau = math.log(tau)
    masked = before == mask_id
    rev = (after != before) if chosen is None else chosen
    gaps = [0.0]
    for s in range(len(lc)):
        if not rev[s].any():
            continue
        best = lc[s][masked[s]].max()
        for p in np.flatnonzero(rev[s]):
            gaps.append(min(max(0.0, log_tau - lc[s, p]), best - lc[s, p]))
        left = masked[s] & ~rev[s]
        if left.any():
            gaps.append(max(0.0, lc[s][left].max() - log_tau))
    return float(max(gaps))


def judge(params, model: dict, reference, judged: List[dict], *,
          tau: float, control: bool = False) -> dict:
    """The numbers compared. ``control``: the reference in fp8 in the
    program's place (it puts first the token, and the position, of its
    own largest logit and confidence), read against the fp32 reference."""
    t = time.perf_counter()
    mask_id = model["mask_token_id"]
    req = [{k: j[k] for k in ("prompt", "context", "states", "state_block")}
           for j in judged]
    if control:
        low = reference.block_stats(params, model, req, precision="fp8")
        gather = [lo["argmax"][..., None] for lo in low]
    else:
        gather = [j["after"][..., None] for j in judged]
    ref = reference.block_stats(params, model, req, gather=gather)
    token_gap = order_gap = 0.0
    unfinished = tokens = 0
    for i, (j, r) in enumerate(zip(judged, ref)):
        before, after = j["states"], j["after"]
        unfinished += int(sum((b == mask_id).sum() for b in j["blocks"]))
        tokens += j["judged_tokens"]
        rev = after != before
        chosen = None
        if control:
            # the control finalizes, where the program finalized, its own
            # most confident masked position
            lc_low = np.where(before == mask_id,
                              low[i]["max"] - low[i]["lse"], -np.inf)
            chosen = np.zeros_like(rev)
            for s in np.flatnonzero(rev.any(-1)):
                chosen[s, int(np.argmax(lc_low[s]))] = True
        gap = r["max"] - r["gathered"][..., 0]
        token_gap = max(token_gap, float(gap[rev].max(initial=0.0)))
        order_gap = max(order_gap, _order_gaps(r["max"] - r["lse"], before,
                                               after, mask_id, tau, chosen))
    return {"choice_gap": max(token_gap, order_gap), "token_gap": token_gap,
            "order_gap": order_gap, "unfinished": unfinished,
            "judged_requests": len(judged), "judged_tokens": tokens,
            "seconds": time.perf_counter() - t}


def compare(numbers: dict, limits: dict) -> Dict[str, dict]:
    """Each number compared, beside its limit."""
    return {name: {"value": numbers[name], "limit": limits[name]}
            for name in COMPARED}
