"""Config system: model architecture + input-shape configs.

A copy of the JAX package's ``configs/base.py`` with torch dtypes.  Each
architecture is a ``ModelCfg`` in its own module with the published
dims, plus a ``smoke()`` reduced config of the same family for CPU
tests.  ``vocab_padded`` is the vocabulary rounded up to a multiple of
128, the embedding table's and the logits' width (``core.padding``).
``padding_report`` scores the model's dims with the card's layout advice
(``core.padding.advise_dim``: one 128-byte line of the compute dtype);
``padded_heads`` and ``stored_kv_heads`` are the reference's head
padding for tensor parallelism, the identity at ``tp = 1``; ``bind(tp,
dp)`` sets the mesh's sizes, as the reference's dry-run does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core.padding import advise_dim, tpu_pad_dim

__all__ = ["MoECfg", "SSMCfg", "ModelCfg", "ShapeCfg", "LM_SHAPES"]


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int = 2
    dense_residual: bool = False     # arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    expert_parallel: bool = False    # EP (experts over 'model') vs TP inside expert


@dataclass(frozen=True)
class SSMCfg:
    state: int = 128       # N
    head_dim: int = 64     # P
    expand: int = 2        # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128       # SSD chunk length Q
    pallas_conv: bool = False  # route the causal conv through the conv
                               # kernel (kernels.conv1d) when S > 1
    conv_tile: int | None = None  # tokens per block of the conv kernel;
                                  # None -> the planner


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    window: Optional[int] = None   # SWA window (mixtral)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    attn_every: int = 0            # hybrid: shared attn block every k ssm blocks
    enc_layers: int = 0            # encdec: encoder depth
    frontend_len: int = 0          # audio frames / vision patches (stub input)
    rope_theta: float = 1e4
    tie_embeddings: bool = True

    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    q_chunk: int = 1024            # query-chunked attention
    loss_chunk: int = 2048         # seq-chunked xent
    remat: bool = True
    remat_groups: int = 0          # >0: two-level scan, remat whole groups
    act_shard: str = ""            # '' | 'seq' | 'dmodel' (sharding hint)
    fsdp: bool = True              # ZeRO-3 weight sharding
    scan_layers: bool = True

    # distribution bind-time fields (configs ship tp=dp=1)
    tp: int = 1
    dp: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        unit = math.lcm(128, max(self.tp, 1))
        return tpu_pad_dim(self.vocab, unit)

    @property
    def padding_report(self) -> dict:
        """:func:`~repro_torch.core.padding.advise_dim` on the reference's
        four dims, in lines of the compute dtype (64 bf16 elements).  A
        dim the model lacks (Mamba2's ``d_ff = 0``) is left out, where the
        reference's report divides by zero."""
        nbytes = torch.empty((), dtype=self.compute_dtype).element_size()
        return {
            name: advise_dim(getattr(self, name), dtype_bytes=nbytes)
            for name in ("vocab", "d_ff", "d_model", "head_dim")
            if getattr(self, name) > 0
        }

    # ---- head padding for TP (the reference's; identity at tp = 1) --------
    @property
    def padded_heads(self) -> int:
        """Q heads padded so the head axis divides tp.

        MHA (q==kv): tail-pad to a multiple of tp.  GQA with q%tp!=0: pad
        *each kv group* g→g' so kv·g' % tp == 0, which keeps the q-head →
        kv-head map a consecutive repeat."""
        hq, hkv, tp = self.n_heads, self.n_kv_heads, self.tp
        if tp <= 1 or hq % tp == 0:
            return hq
        if hq == hkv:
            return -(-hq // tp) * tp
        g = hq // hkv
        gp = g
        while (hkv * gp) % tp:
            gp += 1
        return hkv * gp

    @property
    def stored_kv_heads(self) -> int:
        """KV heads as stored in compute/cache so the head dim shards."""
        hkv, tp = self.n_kv_heads, self.tp
        if tp <= 1 or hkv % tp == 0:
            return hkv
        if self.n_heads == self.n_kv_heads:
            return self.padded_heads  # padded-MHA: kv tail-padded with q
        if tp % hkv == 0:
            return tp  # replicate each kv head tp/hkv times
        raise ValueError(f"{self.name}: kv={hkv} vs tp={tp} unsupported")

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def bind(self, tp: int, dp: int = 1) -> "ModelCfg":
        """The config bound to a mesh: ``tp`` pads the heads,
        ``dp`` groups the MoE dispatch (the dry-run's rebinding)."""
        return dataclasses.replace(self, tp=tp, dp=dp)

    def param_count(self) -> int:
        """Total parameters N (raw dims), for MODEL_FLOPS = 6·N·D."""
        from ..models.model_api import count_params  # late import

        return count_params(self)

    def active_param_count(self) -> int:
        from ..models.model_api import count_params

        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
