"""Model and run configurations (counterpart of ``repro.configs.base``:
``ModelConfig``, ``EncoderConfig``, ``VOCAB_PAD`` and ``FLRunConfig``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "EncoderConfig", "FLRunConfig", "VOCAB_PAD"]

VOCAB_PAD = 256  # pad vocab to a multiple of this (standard TP practice)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder--decoder (whisper) architectures."""

    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    seq_len: int  # fixed encoder positions (whisper: 1500 frames)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture (counterpart of ``repro.configs.base.ModelConfig``,
    field for field, with its ``padded_vocab``, ``effective_pattern``,
    ``is_homogeneous`` and ``param_count``)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # query heads (attention blocks); 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on expert
    router_aux_coef: float = 0.01  # load-balance auxiliary loss

    # SSM / hybrid
    block_pattern: Tuple[str, ...] = ()  # e.g. ("recurrent","recurrent","attention")
    rnn_width: int = 0  # RG-LRU recurrence width (0 => d_model)
    conv_width: int = 4  # temporal conv width in recurrent blocks
    window: int = 0  # local/sliding attention window (0 = full causal)

    # modality frontend (STUB per task spec: embeddings come from input_specs)
    frontend: str = "none"  # none | vision_stub | audio_stub
    frontend_seq: int = 0  # number of frontend tokens (patches / frames)
    encoder: Optional[EncoderConfig] = None  # whisper enc-dec

    # tensor-parallel head padding: pad q heads up to a multiple of this
    # (0 = off). Padded heads are zero-init + statically masked -> exact
    # logical-head semantics; avoids GSPMD re-sharding all-reduces of the
    # score tensors when the TP degree does not divide n_heads (§Perf).
    tp_head_pad: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # provenance
    source: str = ""  # citation (arXiv / model card), from the assignment

    def __post_init__(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "mlp"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads (GQA)")
        if self.family == "moe" and (self.n_experts < 2 or self.experts_per_token < 1):
            raise ValueError("moe family needs n_experts>=2 and experts_per_token>=1")

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    @property
    def effective_pattern(self) -> Tuple[str, ...]:
        """Per-layer block types of length n_layers."""
        if not self.block_pattern:
            default = {
                "dense": "attention",
                "vlm": "attention",
                "audio": "attention",
                "moe": "moe",
                "ssm": "rwkv",
                "hybrid": "recurrent",
            }[self.family]
            return (default,) * self.n_layers
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def is_homogeneous(self) -> bool:
        pat = self.effective_pattern
        return all(p == pat[0] for p in pat)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), used for
        MODEL_FLOPS = 6*N*D in the roofline and sanity-checked in tests."""
        d, v = self.d_model, self.padded_vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # output head
        total += d  # final norm
        hd = self.head_dim
        for kind in self.effective_pattern:
            total += d  # pre-norm scale
            if kind in ("attention", "local_attention"):
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += qkv + (self.n_heads * hd) * d
                total += d + 3 * d * self.d_ff  # mlp norm + swiglu
            elif kind == "moe":
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += qkv + (self.n_heads * hd) * d
                total += d + d * self.n_experts  # mlp norm + router
                total += self.n_experts * 3 * d * self.d_ff
                if self.shared_expert:
                    total += 3 * d * self.d_ff
            elif kind == "rwkv":
                n_h = d // 64
                # r,k,v,g,o projections + data-dependent decay lora + ffn
                total += 5 * d * d + 2 * (d * 64 + 64 * d) + n_h * 64
                total += d + 2 * d * self.d_ff  # rwkv channel-mix (k,v)
            elif kind == "recurrent":
                w = self.rnn_width or d
                total += d * w * 2 + w * self.conv_width + w * 2  # in-proj x2, conv, gates' lora approx
                total += 2 * w * w // 8  # gate projections (block-diagonal, 8 blocks)
                total += w * d  # out proj
                total += d + 3 * d * self.d_ff
            else:
                raise ValueError(f"unknown block kind {kind}")
        if self.encoder is not None:
            e = self.encoder
            total += e.n_layers * (2 * e.d_model + 4 * e.d_model * e.d_model + 2 * e.d_model * e.d_ff)
            total += e.seq_len * e.d_model  # learned positions
            # decoder cross-attention (added per decoder layer)
            total += self.n_layers * (d + 4 * d * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * self.d_ff
        return int(self.param_count() - len(self.effective_pattern) * inactive)


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    """One decentralized-FL training run (paper Algorithm 1 hyperparams).
    The reference's fields and defaults, less its multi-pod knob
    (``pod_gossip_every``), which belongs to the multi-GPU engine the
    port does not have yet."""

    algorithm: str = "dsgt"  # dsgd | dsgt
    q: int = 1  # local steps per comm round (paper: 100)
    topology: str = "ring"  # ring | torus | complete | star | hospital20
    n_nodes: int = 16
    batch_per_node: int = 16  # m in the paper (samples per local step)
    alpha0: float = 0.02  # paper: alpha^r = 0.02/sqrt(r)
    schedule: str = "inv_sqrt"  # inv_sqrt | constant | theorem1
    seed: int = 0
    wire_dtype: Optional[str] = None  # e.g. "bfloat16": the exact-wire engines' payload
