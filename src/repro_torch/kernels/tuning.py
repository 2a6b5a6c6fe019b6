"""Kernel tuning: one :class:`KernelConfig` of the CUDA kernels' runtime
knobs, and a table of swept-best configs per ``(op, shape bucket,
backend)``: the counterpart of the JAX package's ``kernels/tuning.py``.

The knobs are the launch parameters the kernels already take as
arguments; every tile size is a template constant of its ``.cu`` source
and is not a knob:

- ``tiles_per_split``: 64-key tiles each split of the bf16 decode kernel
  walks (dense and paged alike; ``decode_attn/ref.py::split_plan``);
- ``vocab_tiles_per_chunk``: vocab tiles per chunk of the select and xent
  forward grids (``_build.chunking``);
- ``bwd_chunk``: vocab rows per chunk of the xent backward
  (``xent/ops.py::backward_chunk``), a multiple of 128.

Block attention has none: ``resolve("block_attn", ...)`` returns an empty
config, and the sweep says so.

A wrapper called without ``config=`` resolves its knobs from the tuned
table (:data:`TABLE_PATH`, ``tuned_configs_cuda.json`` beside this file,
never the JAX package's table), then from the built-in rules
(:data:`OP_DEFAULTS`, the rules the wrappers used before the table existed,
so an empty table launches exactly what they launched). Precedence, per
knob:

    ``config=`` field  >  tuned table  >  built-in rule

The table's backend is the device type and the card's name
(``cuda:NVIDIA H100 80GB HBM3``), so an entry tuned on one card is never
applied to another. An unknown ``(op, bucket, backend)`` gives the
built-in rule, and that is all; a knob out of its kernel's range raises.

:func:`run_sweep` (``benchmarks/bench_kernels_torch.py --tune``) times
every candidate on the card by CUDA events over a CUDA graph of its calls
(the device's time, as the engines' graphs replay the kernels; an eager
call of the decode kernels is set by the host's launch cost). Given the
log of an earlier sweep (``prior``, from another process, best another
machine), it writes an entry only where a candidate beat the built-in rule
in both sweeps by more than the larger of :data:`SWEEP_MARGIN` and the
spread of the rule's own times between the two (:func:`pick_entries`).
It raises on the CPU: a plain version's time says nothing about a kernel.
"""
from __future__ import annotations

import dataclasses
import json
import os
from functools import lru_cache
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import ref as dref

TABLE_PATH = Path(__file__).resolve().parent / "tuned_configs_cuda.json"

OPS = ("select", "xent", "decode_attn", "block_attn")
# a candidate is written to the table only if it beats the built-in rule's
# time by more than this share (or than the rule's spread between sweeps)
SWEEP_MARGIN = 0.02
# time_us keeps the best of this many timed windows; a sweep times this
# many calls a window (xent's calls are milliseconds: fewer)
REPEATS = 3
SWEEP_ITERS = 20
XENT_SWEEP_ITERS = 5


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The CUDA kernels' runtime knobs (module docstring). ``None`` means
    "not specified": resolution falls through to the tuned table, then to
    the op's built-in rule."""
    tiles_per_split: Optional[int] = None
    vocab_tiles_per_chunk: Optional[int] = None
    bwd_chunk: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KernelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown KernelConfig fields {sorted(unknown)}")
        return cls(**d)


def _tiles(op: str, dtype):
    """(row tile, vocab tile, blocks per SM) of the select or xent forward
    kernel for ``dtype``: the wrappers' ``TILES``."""
    if op == "select":
        from repro_torch.kernels.select.ops import TILES
    else:
        from repro_torch.kernels.xent.ops import TILES
    return TILES[dtype]


def _decode_rule(*, Kv: int, rows: int, **_) -> KernelConfig:
    return KernelConfig(tiles_per_split=dref.tiles_per_split(Kv, rows))


def _select_rule(*, T: int, V: int, n_sms: int, dtype, **_) -> KernelConfig:
    per_chunk, _ = _build.chunking(T, V, n_sms, *_tiles("select", dtype))
    return KernelConfig(vocab_tiles_per_chunk=per_chunk)


def _xent_rule(*, T: int, V: int, n_sms: int, dtype, **_) -> KernelConfig:
    from repro_torch.kernels.xent.ops import backward_chunk
    per_chunk, _ = _build.chunking(T, V, n_sms, *_tiles("xent", dtype))
    return KernelConfig(vocab_tiles_per_chunk=per_chunk,
                        bwd_chunk=backward_chunk(T, V))


#: The built-in rules per op: the wrappers' rules before the tuned table,
#: so an empty or unknown table reproduces their launches exactly.
OP_DEFAULTS: Dict[str, Callable[..., KernelConfig]] = {
    "select": _select_rule,
    "xent": _xent_rule,
    "decode_attn": _decode_rule,
    "block_attn": lambda **_: KernelConfig(),
}


def pow2_bucket(n: int) -> int:
    """Round ``n`` up to the next power of two (the bucket granularity)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def bucket_for(op: str, **shape) -> str:
    """Coarse shape-bucket label per op. Block attention buckets on the
    sequence (``L{pow2}``), as in the JAX package. select and xent bucket
    on the vocabulary as the JAX package does and on the rows too
    (``V{pow2}_T{pow2}``): their built-in rules are functions of T (the
    forward's chunking fills the SMs with T's row tiles; the backward's
    chunk keeps ``4 T chunk`` bytes of scratch within ``PROBS_BYTES``), so
    a knob measured at one T is applied only at that T's bucket. Decode
    attention buckets on the KV heads and the folded rows Bq * G
    (``Kv{Kv}_R{pow2(rows)}``), never on the cache length as the JAX
    package's ``S{pow2}`` does: the dense and paged kernels must split
    alike to stay bit-equal, and their S differ (the paged kernel's is the
    table's pages times the page size), so the split may depend on Kv and
    the rows only, as ``decode_attn/ref.py::tiles_per_split`` does."""
    if op in ("select", "xent"):
        return f"V{pow2_bucket(shape['V'])}_T{pow2_bucket(shape['T'])}"
    if op == "decode_attn":
        return f"Kv{shape['Kv']}_R{pow2_bucket(shape['rows'])}"
    if op == "block_attn":
        return f"L{pow2_bucket(shape['L'])}"
    raise ValueError(f"unknown op {op!r} (expected one of {OPS})")


@lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend(device=None) -> str:
    """``cuda:<card name>`` for a CUDA device (the current one by default
    when CUDA is available), else the device type."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return f"cuda:{_card_name(index)}"


# ---------------------------------------------------------------------------
# Registry (load / lookup / resolve / save)
# ---------------------------------------------------------------------------
_TABLE_CACHE: Dict[str, Dict[Tuple[str, str, str], Dict[str, Any]]] = {}


def _load() -> Dict[Tuple[str, str, str], Dict[str, Any]]:
    """The entries of the table at :data:`TABLE_PATH` (read once per path),
    keyed by ``(op, bucket, backend)``; none when the file is absent."""
    path = str(TABLE_PATH)
    if path in _TABLE_CACHE:
        return _TABLE_CACHE[path]
    entries: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        for e in data.get("entries", []):
            entries[(e["op"], e["bucket"], e["backend"])] = e
    _TABLE_CACHE[path] = entries
    return entries


def clear_cache() -> None:
    """Drop the in-process table cache (after the file was rewritten)."""
    _TABLE_CACHE.clear()


def lookup(op: str, bucket: str, *,
           backend_name: Optional[str] = None) -> Optional[KernelConfig]:
    """The table's config for ``(op, bucket, backend)``; ``None`` when the
    table has no entry (the built-in rule then holds)."""
    entry = _load().get((op, bucket, backend_name or backend()))
    if entry is None:
        return None
    return KernelConfig.from_dict(entry["config"])


def _validate(op: str, cfg: KernelConfig) -> None:
    t = cfg.tiles_per_split
    if t is not None and not 1 <= t <= dref.MAX_TILES_PER_SPLIT:
        raise ValueError(f"{op}: tiles_per_split {t} not in [1, "
                         f"{dref.MAX_TILES_PER_SPLIT}] (decode_attn.cu's "
                         "kMaxT)")
    c = cfg.vocab_tiles_per_chunk
    if c is not None and c < 1:
        raise ValueError(f"{op}: vocab_tiles_per_chunk {c} < 1")
    from repro_torch.kernels.xent.ops import CHUNK_ALIGN
    b = cfg.bwd_chunk
    if b is not None and (b < CHUNK_ALIGN or b % CHUNK_ALIGN):
        raise ValueError(f"{op}: bwd_chunk {b} is not a positive multiple "
                         f"of {CHUNK_ALIGN}")


def resolve(op: str, *, config: Optional[KernelConfig] = None,
            backend_name: Optional[str] = None, **shape) -> KernelConfig:
    """Fully resolved config of one op call: ``config``'s set fields over
    the table's entry for the call's bucket and backend, over the op's
    built-in rule at ``shape``. Shapes: decode_attn ``Kv, rows``; select
    and xent ``T, V, n_sms, dtype``; block_attn ``L``."""
    if op not in OP_DEFAULTS:
        raise ValueError(f"unknown op {op!r} (expected one of {OPS})")
    merged = OP_DEFAULTS[op](**shape).to_dict()
    tuned = lookup(op, bucket_for(op, **shape), backend_name=backend_name)
    for layer in (tuned, config):
        if layer is not None:
            merged.update(layer.to_dict())
    got = KernelConfig(**merged)
    _validate(op, got)
    return got


def save_table(entries: List[Dict[str, Any]], drop=()) -> str:
    """Write a sweep's entries into the table at :data:`TABLE_PATH`,
    replacing same-key rows, after dropping the rows keyed in ``drop``
    (the swept buckets no candidate won); other rows are kept."""
    merged = {k: e for k, e in _load().items() if k not in drop}
    for e in entries:
        merged[(e["op"], e["bucket"], e["backend"])] = e
    rows = sorted(merged.values(),
                  key=lambda e: (e["op"], e["bucket"], e["backend"]))
    path = str(TABLE_PATH)
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": rows}, f, indent=2,
                  sort_keys=True)
        f.write("\n")
    _TABLE_CACHE.pop(path, None)
    return path


# ---------------------------------------------------------------------------
# Candidates and sweeps
# ---------------------------------------------------------------------------
# the main path's decode head layouts (config, Kv, G, hd), at a CDLM block
# (Bq 32) and at the AR step (Bq 1)
DECODE_SHAPES = (("qwen2-0.5b", 2, 7, 64), ("dream-7b", 4, 7, 128),
                 ("llada-8b", 32, 1, 128))
DECODE_BQ = (32, 1)
SELECT_SHAPE = dict(T=256, d=896)       # 8 lanes x a 32-token block
SELECT_VOCABS = (32_768, 131_072, 151_936)
# the training path's rows (a batch of 1,024 tokens) and a 4x larger
# batch's, at qwen2-0.5b's width and vocabulary
XENT_SHAPE = dict(d=896, V=151_936)
XENT_TS = (1024, 4096)
_SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)
# the backward chunk's reach further: the sweep found the rule's 16 MB
# scratch beaten at 4x on both rows it times
_BWD_SCALES = _SCALES + (8.0,)


def candidates(op: str, **shape) -> List[KernelConfig]:
    """What :func:`run_sweep` tries for ``op`` at ``shape`` (the shapes of
    :func:`resolve`), the built-in rule's config first: every power-of-two
    split up to the kernel's most; the rule's vocab tiles per chunk scaled
    by 1/4 to 4; xent's backward chunk scaled by 1/4 to 8 (whole 128-row
    tiles, at most the vocabulary). None for block_attn."""
    if op == "block_attn":
        return []
    rule = OP_DEFAULTS[op](**shape)
    if op == "decode_attn":
        out = [KernelConfig(tiles_per_split=1 << i)
               for i in range(dref.MAX_TILES_PER_SPLIT.bit_length())]
    else:
        r = rule.vocab_tiles_per_chunk
        out = [dataclasses.replace(rule,
                                   vocab_tiles_per_chunk=max(1, round(r * f)))
               for f in _SCALES]
    if op == "xent":
        from repro_torch.kernels.xent.ops import CHUNK_ALIGN
        c, top = rule.bwd_chunk, -(-shape["V"] // CHUNK_ALIGN) * CHUNK_ALIGN
        out += [dataclasses.replace(rule, bwd_chunk=min(
            top, CHUNK_ALIGN * max(1, round(c * f / CHUNK_ALIGN))))
            for f in _BWD_SCALES]
    return list(dict.fromkeys([rule] + out))


def time_us(fn, *, iters: int = 20, graph: bool = True) -> float:
    """Microseconds per call of ``fn`` on the card, by CUDA events, the best
    of :data:`REPEATS` means over ``iters`` calls. ``graph`` (the default):
    the ``iters`` calls captured once in a CUDA graph (``graphs.Graph``)
    and replayed, so the time is the device's without the host's launch
    cost, as the engines' graphs see it; the sweep ranks candidates by it.
    Else back-to-back eager calls after one warm call: the host's dispatch
    included, as an eager caller sees it."""
    if graph:
        from repro_torch.graphs import Graph
        g = Graph(lambda: [fn() for _ in range(iters)])
        run, per = g.replay, iters
    else:
        fn()
        run, per = fn, 1
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters // per):
            run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters * 1e3)
    return best


def _row(log, op, shape, part, cfg, us, **extra):
    """One timed candidate of a sweep's log: its group ``(op, bucket,
    part)``, the shape (``extra``: what the bucket does not read), the
    candidate's and the rule's knobs."""
    log.append({"op": op, "bucket": bucket_for(op, **shape), "part": part,
                "shape": {**{k: v for k, v in shape.items() if k != "dtype"},
                          **extra},
                "knobs": cfg.to_dict(),
                "builtin": OP_DEFAULTS[op](**shape).to_dict(), "us": us})


def pick_entries(runs: List[List[Dict[str, Any]]], backend_name: str
                 ) -> Tuple[List[Dict[str, Any]], float]:
    """The table entries of one or more sweeps' logs, and the margin they
    were held to. A group is one ``(op, bucket, part)``. The margin is the
    larger of :data:`SWEEP_MARGIN` and the spread: the largest relative
    difference of a group's built-in rule between the sweeps (none with
    one sweep). A candidate wins its group if it beat the rule of the same
    sweep by more than the margin in every sweep; of several, the one whose
    smallest gain is largest. An entry sets only the knobs in which its
    winners differ from the rule, and holds the winners of an (op,
    bucket)'s parts (xent's forward and backward) together."""
    groups: Dict[tuple, Dict[str, Any]] = {}
    for i, log in enumerate(runs):
        for r in log:
            g = groups.setdefault((r["op"], r["bucket"], r["part"]), {
                "shape": r["shape"], "rule": r["builtin"], "times": {}})
            g["times"].setdefault(json.dumps(r["knobs"], sort_keys=True),
                                  [None] * len(runs))[i] = r["us"]
    rule_times = [g["times"].get(json.dumps(g["rule"], sort_keys=True))
                  for g in groups.values()]
    spread = max([max(t) / min(t) - 1 for t in rule_times
                  if t and None not in t and len(t) > 1], default=0.0)
    margin = max(SWEEP_MARGIN, spread)
    entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for (op, bucket, part), g in sorted(groups.items()):
        rule_key = json.dumps(g["rule"], sort_keys=True)
        base = g["times"].get(rule_key)
        if not base or None in base:
            continue
        gains = [(min(1 - t / b for t, b in zip(ts, base)), key, ts)
                 for key, ts in g["times"].items()
                 if key != rule_key and None not in ts]
        if not gains:
            continue
        gain, key, ts = max(gains)
        win = gain > margin
        print(f"  {op} {bucket} {part}: built-in {g['rule']} "
              f"{[round(b, 2) for b in base]} us, best {key} "
              f"{[round(t, 2) for t in ts]} us (least gain {gain:.1%}) "
              f"-> {'table' if win else 'built-in'}", flush=True)
        if not win:
            continue
        knobs = json.loads(key)
        e = entries.setdefault((op, bucket), {
            "op": op, "bucket": bucket, "backend": backend_name,
            "config": {}, "builtin": g["rule"], "shape": g["shape"],
            "metric": "us_per_call", "margin": round(margin, 4),
            "us": {}})
        e["config"].update({k: v for k, v in knobs.items()
                            if g["rule"].get(k) != v})
        e["us"][part] = {"builtin": [round(b, 2) for b in base],
                         "tuned": [round(t, 2) for t in ts]}
    return list(entries.values()), margin


def _bf16(gen, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


def sweep_decode_attn(*, dev, log):
    """tiles_per_split of the bf16 dense decode kernel at the main path's
    head layouts (the paged kernel takes the same split from the same
    key): 8 lanes at cache lengths 512..736 of S=768 (Bq 32) or 512..575
    of S=576 (Bq 1)."""
    from repro_torch.kernels.decode_attn import decode_attention
    for name, Kv, G, hd in DECODE_SHAPES:
        for Bq in DECODE_BQ:
            b, S, hi = (8, 768, 736) if Bq > 1 else (8, 576, 575)
            g = torch.Generator(device=dev).manual_seed(Kv * hd + Bq)
            q = _bf16(g, dev, b, Bq, Kv, G, hd)
            kc, vc = _bf16(g, dev, b, S, Kv, hd), _bf16(g, dev, b, S, Kv, hd)
            kb, vb = _bf16(g, dev, b, Bq, Kv, hd), _bf16(g, dev, b, Bq, Kv,
                                                         hd)
            lens = torch.linspace(512, hi, b, device=dev).to(torch.int32)
            shape = dict(Kv=Kv, rows=Bq * G)
            for cfg in candidates("decode_attn", **shape):
                us = time_us(lambda: decode_attention(
                    q, kc, vc, kb, vb, lens, scale=hd ** -0.5, config=cfg),
                    iters=SWEEP_ITERS)
                _row(log, "decode_attn", shape, "call", cfg, us, model=name,
                     b=b, Bq=Bq, G=G, hd=hd, S=S)


def sweep_select(*, dev, log):
    """vocab_tiles_per_chunk of the bf16 select kernel at a decode
    iteration's rows (8 lanes x 32) and qwen2-0.5b's width, per vocabulary
    bucket."""
    from repro_torch.kernels.select import fused_select
    T, d = SELECT_SHAPE["T"], SELECT_SHAPE["d"]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for V in SELECT_VOCABS:
        g = torch.Generator(device=dev).manual_seed(V % 1000)
        h, w = _bf16(g, dev, T, d), _bf16(g, dev, V, d, scale=0.02)
        m = torch.rand((T,), generator=g, device=dev) < 0.7
        shape = dict(T=T, V=V, n_sms=n_sms, dtype=torch.bfloat16)
        for cfg in candidates("select", **shape):
            us = time_us(lambda: fused_select(h, w, m, config=cfg),
                         iters=SWEEP_ITERS)
            _row(log, "select", shape, "call", cfg, us, d=d)


def sweep_xent(*, dev, log):
    """xent's forward vocab tiles per chunk and backward chunk, bf16, at
    the training path's width and vocabulary and each of ``XENT_TS``'s
    rows, timed apart: the forward's candidates alone, the backward's
    alone (parts ``forward`` and ``backward`` of one bucket)."""
    from repro_torch.kernels.xent import ops as xops
    d, V = XENT_SHAPE["d"], XENT_SHAPE["V"]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for T in XENT_TS:
        g = torch.Generator(device=dev).manual_seed(V % 1000 + T)
        h, w = _bf16(g, dev, T, d), _bf16(g, dev, V, d, scale=0.02)
        y = torch.randint(0, V, (T,), generator=g, device=dev)
        gr = torch.rand((T,), generator=g, device=dev)
        shape = dict(T=T, V=V, n_sms=n_sms, dtype=torch.bfloat16)
        rule = OP_DEFAULTS["xent"](**shape)
        _, logz = xops._forward(h, w, y)
        for cfg in candidates("xent", **shape):
            if cfg.bwd_chunk == rule.bwd_chunk:
                _row(log, "xent", shape, "forward", cfg, time_us(
                    lambda: xops._forward(h, w, y, config=cfg),
                    iters=XENT_SWEEP_ITERS), d=d)
            if cfg.vocab_tiles_per_chunk == rule.vocab_tiles_per_chunk:
                _row(log, "xent", shape, "backward", cfg, time_us(
                    lambda: xops._backward(h, w, y, logz, gr, True,
                                           config=cfg),
                    iters=XENT_SWEEP_ITERS), d=d)


def run_sweep(ops: Optional[Tuple[str, ...]] = None, *, device="cuda",
              log: Optional[list] = None,
              prior: Optional[List[Dict[str, Any]]] = None
              ) -> List[Dict[str, Any]]:
    """Sweep ``ops`` (all by default) on the CUDA ``device`` and write the
    winners into the table at :data:`TABLE_PATH`, replacing every entry of
    the swept buckets for this card. ``log`` (a list) receives this
    sweep's timed candidates; ``prior``, an earlier sweep's, which each
    winner must win in too (:func:`pick_entries`). Raises on the CPU,
    where only the plain versions run."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"run_sweep times the CUDA kernels; on {dev} only "
                           "their plain versions run, whose times say "
                           "nothing about a kernel")
    ops = ops or OPS
    unknown = set(ops) - set(OPS)
    if unknown:
        raise ValueError(f"unknown ops {sorted(unknown)} (expected {OPS})")
    rows = [] if log is None else log
    if "select" in ops:
        sweep_select(dev=dev, log=rows)
    if "xent" in ops:
        sweep_xent(dev=dev, log=rows)
    if "decode_attn" in ops:
        sweep_decode_attn(dev=dev, log=rows)
    if "block_attn" in ops:
        print("  block_attn: no runtime knob (its tiles are template "
              "constants of block_attn.cu); nothing to sweep", flush=True)
    name = backend(dev)
    runs = [rows] if prior is None else [prior, rows]
    entries, margin = pick_entries(runs, name)
    path = save_table(entries, drop={(r["op"], r["bucket"], name)
                                     for r in rows})
    print(f"wrote {len(entries)} tuned configs (margin {margin:.2%}, "
          f"{len(runs)} sweep(s)) -> {path}", flush=True)
    return entries
