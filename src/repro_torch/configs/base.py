"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``configs/base.py``, limited to what the port
uses: the layer kinds, ``ModelConfig`` (with ``reduced()``, the parameter
counts and the backbone predicates), ``check_supported`` (the slot kinds,
norm and activation the port's model stack runs),
``CDLMConfig``, ``TrainConfig``, ``ServeConfig``, ``ShapeConfig`` with
``INPUT_SHAPES`` (the dry-run's four input shapes) and ``HardwareConfig``
(the roofline constants of the paper's A100 and of the port's H100). The
port keeps its own copy so that it imports nothing of the JAX package; the
field names, defaults and derived properties are the same, so a config
built on either side describes the same model. ``ModelConfig`` adds two
fields of the port's own (``PORT_FIELDS``), which every config copied from
the JAX package leaves at their defaults: ``qk_norm`` and
``moe_dispatch``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds of the per-period layer program (see models/transformer.py).
ATTN = "attn"          # self attention (mode decided at call time)
ATTN_LOCAL = "attn_local"  # sliding-window self attention (gemma2 local)
MAMBA = "mamba"        # selective SSM block (jamba)
RWKV = "rwkv"          # RWKV6 time-mix block

MLP = "mlp"            # dense FFN
MOE = "moe"            # mixture-of-experts FFN
RWKV_CM = "rwkv_cm"    # RWKV6 channel-mix (token-shifted FFN)

MOE_DISPATCH = ("capacity", "grouped")
# ModelConfig's fields that the JAX package's ModelConfig has not
PORT_FIELDS = ("qk_norm", "moe_dispatch")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per architecture."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio

    # Core dims
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # Attention flavor
    qkv_bias: bool = False           # qwen-style QKV bias
    rope_theta: float = 10_000.0
    # per-head RMSNorm of q and k before RoPE (Qwen3's q_norm / k_norm);
    # port only
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None         # window for ATTN_LOCAL layers
    query_pre_attn_scalar: Optional[float] = None
    # sliding-window decode variant: caps the attended cache length
    long_context_window: Optional[int] = None

    # FFN flavor
    activation: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None
    n_shared_experts: int = 0
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    # "capacity": the reference's capacity-bounded scatter (tokens past an
    # expert's capacity drop); "grouped": every choice of every token
    # computed, by the dropless grouped expert product (models/moe.py);
    # port only
    moe_dispatch: str = "capacity"

    # SSM (mamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV6
    rwkv_head_size: int = 64

    # Layer program: layer i uses layer_period[i % len(layer_period)];
    # each slot is (mixer_kind, ffn_kind).
    layer_period: Tuple[Tuple[str, str], ...] = ((ATTN, MLP),)

    pos_embed: str = "rope"

    # Norms / embeddings
    norm_eps: float = 1e-6
    norm_type: str = "rmsnorm"
    tie_embeddings: bool = False
    embed_scale: bool = False        # scale embeddings by sqrt(d_model)

    # Encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0

    # Prefix embedding positions supplied pre-computed (VLM patches)
    n_prefix_embeds: int = 0

    # Diffusion
    mask_token_id: int = 0
    eos_token_id: int = 1

    # Numerics: param / activation / KV-cache dtype
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.n_heads % max(self.n_kv_heads, 1) != 0 and self.family != "ssm":
            raise ValueError(f"{self.name}: n_heads={self.n_heads} not a "
                             f"multiple of n_kv_heads={self.n_kv_heads}")
        if self.moe_dispatch not in MOE_DISPATCH:
            raise ValueError(f"{self.name}: moe_dispatch "
                             f"{self.moe_dispatch!r} is not one of "
                             f"{MOE_DISPATCH}")
        if self.n_layers % len(self.layer_period) != 0:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not a "
                             f"multiple of period {len(self.layer_period)}")

    # ---- derived -----------------------------------------------------------
    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_period)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return all(mix in (MAMBA, RWKV) for mix, _ in self.layer_period)

    @property
    def supports_bidirectional(self) -> bool:
        """Can this backbone act as a bidirectional DLM teacher?"""
        return not any(mix in (MAMBA, RWKV) for mix, _ in self.layer_period)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head), as the JAX
        package counts it (the Mamba and RWKV terms approximate)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        glu = 3  # gated FFNs use 3 matrices
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        per = {}
        per[ATTN] = (d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                     + (2 * hd if self.qk_norm else 0))
        per[ATTN_LOCAL] = per[ATTN]
        exp = self.mamba_expand * d
        per[MAMBA] = (d * exp * 2 + exp * self.mamba_d_conv
                      + exp * (self.mamba_d_state * 2 + 1) + exp * d)
        per[RWKV] = 4 * d * d + d * d
        per[MLP] = glu * d * self.d_ff
        per[RWKV_CM] = 2 * d * self.d_ff + d * d
        if self.n_experts:
            per[MOE] = ((self.n_experts + self.n_shared_experts)
                        * glu * d * self.moe_d_ff + d * self.n_experts)
        for mix, ffn in self.layer_period:
            per.setdefault((mix, ffn), per[mix] + per[ffn] + 2 * d)
        total += sum(per[(mix, ffn)]
                     for mix, ffn in self.layer_period) * self.n_periods
        if self.is_encoder_decoder:
            # encoder layers, and cross attention in every decoder layer
            total += self.n_encoder_layers * (per[ATTN] + per[MLP] + 2 * d)
            total += self.n_layers * per[ATTN]
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed and shared
        experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full_moe = self.n_experts * 3 * d * self.moe_d_ff
        active_moe = ((self.experts_per_token + self.n_shared_experts)
                      * 3 * d * self.moe_d_ff)
        n_moe_layers = sum(1 for _, f in self.layer_period
                           if f == MOE) * self.n_periods
        return int(self.param_count() - n_moe_layers * (full_moe
                                                        - active_moe))

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, tiny vocab."""
        period = self.layer_period
        small = dict(
            n_layers=len(period) * min(2, self.n_periods),
            d_model=256 if self.d_model >= 256 else self.d_model,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=64,
            d_ff=512,
            vocab_size=512,
            mask_token_id=511,
            eos_token_id=1,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.n_experts else 0),
            moe_d_ff=256 if self.n_experts else None,
            n_shared_experts=min(self.n_shared_experts, 1),
            sliding_window=64 if self.sliding_window else None,
            long_context_window=128 if self.long_context_window else None,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else 0,
            n_prefix_embeds=8 if self.n_prefix_embeds else 0,
            query_pre_attn_scalar=(64.0 if self.query_pre_attn_scalar
                                   else None),
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# what the port's model stack runs (``check_supported``)
MIXERS = (ATTN, ATTN_LOCAL, MAMBA, RWKV)
FFNS = (MLP, MOE, RWKV_CM)
# "none": positions from the recurrence; "sinusoidal": whisper's table,
# added to the embeddings
POS_EMBEDS = ("rope", "sinusoidal", "none")
NORMS = ("rmsnorm", "layernorm")
# the gated FFN's silu or gelu, whisper's non-gated gelu ("gelu_plain");
# "relu_sq" names rwkv6's channel mix, whose squared ReLU is fixed in
# models/rwkv6.py::channel_mix
ACTIVATIONS = ("silu", "gelu", "gelu_plain", "relu_sq")


def check_supported(cfg: ModelConfig) -> None:
    """Raises for a config the port's stack does not run: a mixer other
    than ``ATTN``/``ATTN_LOCAL``/``MAMBA``/``RWKV`` or an FFN other than
    ``MLP``/``MOE``/``RWKV_CM``, positions other than RoPE or sinusoidal
    (or none, for an attention-free stack), a norm other than rmsnorm or
    layernorm, an activation other than silu, gelu, whisper's plain gelu
    or rwkv6's squared ReLU. An encoder-decoder (whisper-base) runs: its
    encoder is one ``(ATTN, MLP)`` slot over ``n_encoder_layers``."""
    bad = [slot for slot in cfg.layer_period
           if slot[0] not in MIXERS or slot[1] not in FFNS]
    if bad:
        raise ValueError(f"{cfg.name}: repro_torch runs {MIXERS} mixers "
                         f"with {FFNS} FFNs only, got slots {bad}")
    if (cfg.pos_embed not in POS_EMBEDS
            or (cfg.pos_embed == "none" and not cfg.is_attention_free)):
        raise ValueError(f"{cfg.name}: repro_torch runs RoPE or sinusoidal "
                         "positions (or, attention-free, none) only, got "
                         f"{cfg.pos_embed!r}")
    if cfg.norm_type not in NORMS or cfg.activation not in ACTIVATIONS:
        raise ValueError(f"{cfg.name}: repro_torch runs {NORMS} norms and "
                         f"{ACTIVATIONS} activations only, got norm "
                         f"{cfg.norm_type!r}, activation {cfg.activation!r}")


@dataclass(frozen=True)
class CDLMConfig:
    """The paper's technique knobs (§4, App. A)."""

    block_size: int = 32             # B
    gen_length: int = 256            # L_g
    prompt_length: int = 512
    # Loss weights (Table 5/6 defaults for Dream)
    w_distill: float = 1.0
    w_cons: float = 0.5
    w_dlm: float = 0.01
    # Inference
    conf_threshold: float = 0.9      # τ_conf
    early_stop: bool = True
    # Trajectory collection (Alg. 1)
    temperatures: Tuple[float, ...] = (0.0, 0.5)
    # Distillation uses forward KL in logit space (App. A.2 findings)
    kl_direction: str = "forward"

    @property
    def n_blocks(self) -> int:
        return self.gen_length // self.block_size


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    warmup_frac: float = 0.05
    lr_schedule: str = "constant"   # constant | cosine
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    batch_size: int = 64
    steps: int = 1000
    seed: int = 0
    use_lora: bool = False
    lora_rank: int = 32
    lora_alpha: float = 32.0
    remat: bool = True               # checkpoint each layer period


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    block_size: int = 32
    gen_length: int = 256
    # engine defaults; requests may override them per request through
    # repro_torch.serving.SamplingParams
    conf_threshold: float = 0.9
    temperature: float = 0.0
    sampler: str = "cdlm"
    cache_refresh_interval: int = 8
    scheduler: str = "static"        # static | continuous
    cache_layout: str = "dense"      # dense | paged
    page_pool_pages: Optional[int] = None
    # fused unembed + online-softmax candidate selection: decode forwards
    # skip the lm_head and no (b, ., V) logits tensor is built
    fused_select: bool = False
    http_host: str = "127.0.0.1"
    http_port: int = 8000


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class HardwareConfig:
    """Roofline constants of one accelerator: dense bf16 peak FLOP/s, HBM
    bytes/s, interconnect bytes/s and HBM bytes. Every field is given: there
    is no default card."""
    name: str
    peak_flops: float                # dense bf16 FLOP/s (tensor cores)
    hbm_bw: float                    # bytes/s
    ici_bw: float                    # interconnect bytes/s
    hbm_bytes: float

    @property
    def ridge_ai(self) -> float:
        return self.peak_flops / self.hbm_bw


# the paper's card (App. B.4), as in the JAX package's configs/base.py
A100 = HardwareConfig(name="a100-sxm4-80g", peak_flops=311.9e12,
                      hbm_bw=2039e9, ici_bw=300e9, hbm_bytes=80e9)
# the port's card: NVIDIA's data sheet for the H100 SXM5 at its 700 W limit
# (dense bf16 without sparsity; ``ici_bw``: NVLink 4's 18 links, both
# directions summed, inside one node; the dry-run prices its collectives by
# ``DGX_H100`` instead)
H100 = HardwareConfig(name="h100-sxm5-80g", peak_flops=989e12,
                      hbm_bw=3.35e12, ici_bw=900e9, hbm_bytes=80e9)
# fp32 FLOP/s outside the tensor cores (the fp32 kernels' route), from the
# same data sheet
H100_FP32_FLOPS = 67e12


@dataclass(frozen=True)
class Fabric:
    """The links a collective crosses: ``node_gpus`` GPUs share one
    NVLink domain at ``nvlink_bw`` each, and a group that spans nodes runs
    at ``network_bw`` each (bytes/s per GPU, one direction)."""
    name: str
    node_gpus: int
    nvlink_bw: float
    network_bw: float


# the nodes the dry-run's meshes are priced on: DGX H100-class, 8 GPUs on
# NVLink 4 (900 GB/s per GPU both ways, 450 GB/s each way) and one 400 Gb/s
# NDR InfiniBand NIC per GPU between nodes (50 GB/s each way), from NVIDIA's
# DGX H100 data sheet
DGX_H100 = Fabric(name="dgx-h100 (8 x NVLink 4, NDR 400G per GPU)",
                  node_gpus=8, nvlink_bw=450e9, network_bw=50e9)
