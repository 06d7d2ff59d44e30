"""Configuration dataclasses: the fields of ``repro.configs.base`` that the
dense serving and training paths read, and the reference's input shapes,
kept as the port's own copy."""
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
class ModelConfig:
    """Dense decoder-only transformer: RoPE, no biases, the norm of
    ``norm`` (RMSNorm, LayerNorm or OLMo's non-parametric LayerNorm) and
    an output head of its own or tied to the embedding
    (``tie_embeddings``).  These cover the reference's dense family
    (llama3-8b, yi-9b, olmo-1b).  The reference's bias, positional,
    mixture-of-experts, Mamba, RWKV, encoder-decoder and sharding fields
    come with the families that set them.

    The training fields are the reference's, with two left out: its
    ``scan_layers`` chooses how XLA compiles the layer stack, and the port
    always loops over the layers in Python; its ``opt_state_dtype`` repeats
    ``OptimizerConfig.state_dtype``, the one field the port reads for the
    AdamW moments' dtype."""
    name: str
    family: str                   # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"             # silu -> SwiGLU MLP; gelu / relu_sq -> 2-matrix MLP
    rope_theta: float = 10000.0
    tie_embeddings: bool = False  # the head is embed.T (no "head" leaf)
    dtype: str = "bfloat16"       # activation / cache dtype
    param_dtype: str = "bfloat16"
    # --- training -------------------------------------------------------
    remat: bool = True            # recompute each layer in the backward
    remat_policy: str = "full"    # full (save nothing) | dots (save matmul outputs)
    grad_accum: int = 1           # microbatches per optimizer step

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kind(self, idx: int) -> str:
        """The mixer of layer ``idx``: attention on every layer of the
        dense family."""
        return "attn"

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
