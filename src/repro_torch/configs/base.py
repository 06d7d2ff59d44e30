"""Configuration dataclasses: the fields of ``repro.configs.base`` that the
dense, MoE, VLM, encoder-decoder, hybrid (Mamba + attention) and
attention-free (RWKV) serving and training paths read, and the
reference's input shapes, kept as the port's own copy."""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SwanConfig:
    """SWAN KV-cache compression configuration.

    ``k_max`` is the allocation-time number of retained dimensions.
    ``k_key``/``k_value`` are the runtime active dimensions (<= k_max):
    packed tails beyond them are zeroed.
    """
    enabled: bool = True
    k_max: int = 64               # allocated retained dims per vector
    buffer: int = 128             # dense ring-buffer length b (recent tokens)
    mode: str = "topk"            # "topk" (paper-faithful) | "truncate"
    quantize: bool = False        # 8-bit values (paper's 8-bit variant)
    quant_dtype: str = "int8"     # "int8" (+ per-vector scale) | "fp8" (e4m3fn cast)
    k_key: Optional[int] = None   # runtime active dims for keys   (None -> k_max)
    k_value: Optional[int] = None  # runtime active dims for values (None -> k_max)
    compress_cross_attn: bool = False  # encdec: winnow the static cross-attn cache

    @property
    def kk(self) -> int:
        return self.k_max if self.k_key is None else self.k_key

    @property
    def kv(self) -> int:
        return self.k_max if self.k_value is None else self.k_value

    def validate(self, d_head: int) -> None:
        if self.k_max > d_head:
            raise ValueError(f"k_max={self.k_max} > d_head={d_head}")
        if self.kk > self.k_max or self.kv > self.k_max:
            raise ValueError("runtime k exceeds allocated k_max")
        if self.mode not in ("topk", "truncate"):
            raise ValueError(f"unknown winnow mode {self.mode!r}")
        if self.quant_dtype not in ("int8", "fp8"):
            raise ValueError(f"unknown quant dtype {self.quant_dtype!r}")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN: routed experts (top-k of them per token,
    with a token capacity per expert) and always-on shared experts;
    ``shard_experts`` chooses the experts' sharding (``sharding.specs``)."""
    n_routed: int                 # number of routed experts
    n_shared: int                 # number of always-on shared experts
    top_k: int                    # experts activated per token
    d_expert: int                 # hidden dim of each expert FFN
    capacity_factor: float = 1.25  # token capacity per expert = cf * tokens * top_k / E
    router_aux_weight: float = 0.01  # load-balance auxiliary loss weight
    router_z_weight: float = 1e-3    # router logit z-loss weight
    moe_every: int = 1            # MoE FFN on layers where (idx % moe_every == moe_offset)
    moe_offset: int = 0
    shard_experts: bool = True    # EP: shard expert dim over the 'model' axis


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block (Jamba's sequence mixer)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) time mix."""
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    """The transformer of the ported families: RoPE or learned positions
    (``pos``), optional q/k/v, attention-output and MLP biases
    (``qkv_bias``, ``attn_out_bias``, ``mlp_bias``), the norm of ``norm``
    (RMSNorm, LayerNorm or OLMo's non-parametric LayerNorm), an output head
    of its own or tied to the embedding (``tie_embeddings``), a
    mixture-of-experts FFN on the layers ``ffn_kind`` names (``moe``), a
    prefix of ``n_prefix_tokens`` patch embeddings ahead of the tokens
    (``vlm``), and an encoder of ``n_encoder_layers`` over ``encoder_seq``
    frames with cross-attention in every decoder layer
    (``is_encoder_decoder``), Mamba mixers with attention on every
    ``attn_period``-th layer at ``attn_offset`` (``mamba``), and RWKV-6
    time mixes in place of attention (``rwkv``).  These cover the
    reference's dense family (llama3-8b, yi-9b, olmo-1b), its ``moe``
    family (deepseek-moe-16b, qwen2-moe-a2.7b), its ``vlm`` family
    (internvl2-1b), its ``encdec`` family (whisper-small), its ``hybrid``
    family (jamba-1.5-large-398b) and its ``ssm`` family (rwkv6-3b).  The
    sharding fields (``tp_style``, ``fsdp_data``, ``seq_shard``) are the
    reference's, read by ``sharding.specs``.

    The training fields are the reference's but ``scan_layers``, which
    chooses how XLA compiles the layer stack (the port always loops over
    the layers in Python); ``opt_state_dtype`` is the AdamW moments' dtype
    the training launcher puts into ``OptimizerConfig.state_dtype``."""
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"             # silu -> SwiGLU MLP; gelu / relu_sq -> 2-matrix MLP
    qkv_bias: bool = False        # bq/bk/bv added before RoPE (Qwen)
    attn_out_bias: bool = False   # bo after the output projection
    mlp_bias: bool = False        # b_up / b_down of the 2-matrix MLP
    pos: str = "rope"             # rope | learned | none
    rope_theta: float = 10000.0
    max_position: int = 1 << 20
    tie_embeddings: bool = False  # the head is embed.T (no "head" leaf)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_period: int = 1          # hybrid: attention on layers where idx % attn_period == attn_offset
    attn_offset: int = 0
    # --- encoder-decoder -------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0          # fixed encoder frame count (whisper stub: 1500)
    # --- vlm --------------------------------------------------------------
    n_prefix_tokens: int = 0      # patch-embedding prefix length (internvl stub)
    dtype: str = "bfloat16"       # activation / cache dtype
    param_dtype: str = "bfloat16"
    # --- sharding profile -------------------------------------------------
    tp_style: str = "heads"       # heads | fsdp_model (tiny archs: model axis used for param storage)
    fsdp_data: bool = False       # additionally shard params/opt over 'data' (405B-class)
    seq_shard: bool = False       # sequence-parallel activations on 'model' axis
    # --- training -------------------------------------------------------
    remat: bool = True            # recompute each layer in the backward
    remat_policy: str = "full"    # full (save nothing) | dots (save matmul outputs)
    grad_accum: int = 1           # microbatches per optimizer step
    opt_state_dtype: str = "float32"  # AdamW moments (bf16 for >=100B configs)

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.rwkv is not None

    def layer_kind(self, idx: int) -> str:
        """The mixer of layer ``idx``: "rwkv" on every layer of an RWKV
        config, "attn" or "mamba" by ``attn_period``/``attn_offset`` in a
        hybrid one, "attn" elsewhere."""
        if self.rwkv is not None:
            return "rwkv"
        if self.mamba is None:
            return "attn"
        return ("attn" if idx % self.attn_period == self.attn_offset
                else "mamba")

    def ffn_kind(self, idx: int) -> str:
        """The FFN of layer ``idx``: "moe" where ``moe`` puts its experts,
        "dense" (an MLP of width ``d_ff``) elsewhere."""
        if self.moe is None:
            return "dense"
        return ("moe" if idx % self.moe.moe_every == self.moe.moe_offset
                else "dense")

    def n_params(self) -> int:
        """Analytical parameter count (embedding, learned positions,
        blocks, an encoder's blocks and its decoder's cross-attention,
        head), the reference's formula.  Its RWKV term leaves out the
        channel mix's receptance ``w_r`` (d² a layer), as the reference's
        does, so it undercounts rwkv6-3b's leaves."""
        return self._count_params(active=False)

    def n_active_params(self) -> int:
        """Parameters a token passes through: a MoE layer counts its top-k
        routed experts, its shared experts and its router; without experts
        it is ``n_params()``, as in the reference."""
        if self.moe is None:
            return self.n_params()
        return self._count_params(active=True)

    def _count_params(self, active: bool) -> int:
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        # the reference's active count (MoE only) has no positional table,
        # encoder, cross-attention or RWKV mixer
        encdec = self.is_encoder_decoder and not active
        if self.pos == "learned" and not active:
            n += self.max_position_learned() * self.d_model
        for idx in range(self.n_layers):
            kind = self.layer_kind(idx)
            if kind == "attn":
                n += self._attn_params()
                if encdec:
                    n += self._attn_params()            # cross attention
            elif kind == "mamba":
                n += self._mamba_params()
            elif not active:
                n += self._rwkv_params()
            if self.ffn_kind(idx) == "dense":
                n += self._mlp_params(self.d_ff)
            else:
                m = self.moe
                experts = (m.top_k if active else m.n_routed) + m.n_shared
                n += experts * self._mlp_params(m.d_expert)
                n += self.d_model * m.n_routed          # router
        if encdec:
            n += self.n_encoder_layers * (self._attn_params()
                                          + self._mlp_params(self.d_ff))
        return n

    def max_position_learned(self) -> int:
        """Rows of the learned positional table."""
        return min(self.max_position, 1 << 16)

    def _attn_params(self) -> int:
        d, H, Kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        n = d * H * dh + 2 * d * Kv * dh + H * dh * d
        if self.qkv_bias:
            n += H * dh + 2 * Kv * dh
        return n

    def _mlp_params(self, ff: int) -> int:
        return (3 if self.act == "silu" else 2) * self.d_model * ff

    def _mamba_params(self) -> int:
        m = self.mamba
        d_in = m.expand * self.d_model
        dt_rank = m.dt_rank or -(-self.d_model // 16)
        n = self.d_model * 2 * d_in                 # in_proj (x & z)
        n += d_in * m.d_conv                        # causal conv
        n += d_in * (dt_rank + 2 * m.d_state)       # x -> dt, B, C
        n += dt_rank * d_in                         # dt_proj
        n += d_in * m.d_state + d_in                # A_log, D
        n += d_in * self.d_model                    # out_proj
        return n

    def _rwkv_params(self) -> int:
        d = self.d_model
        # r, k, v, g, o projections, the decay and bonus vectors, the
        # token-shift mixes and the decay LoRA (the reference's count)
        return 5 * d * d + 4 * d + 2 * (d * 64)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (the reference's shape set for LM-family archs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeConfig("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeConfig("long_500k",   "decode",  524_288, 1),
}


# ---------------------------------------------------------------------------
# Train configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """The reference's training configuration, less its ``loss_dtype``,
    which neither package reads (the loss is always taken in float32).
    ``checkpoint_dir`` defaults to a directory under ``$TMPDIR``."""
    model: ModelConfig
    seq_len: int = 4096
    global_batch: int = 256
    steps: int = 1000
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    grad_compression: str = "none"   # none | int8
