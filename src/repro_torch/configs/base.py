"""Architecture & shape configuration schema.

A field-for-field copy of ``repro.configs.base`` (the JAX package), kept
here because ``repro_torch`` imports nothing from ``repro``;
``tests/test_torch_models.py`` holds the two copies equal. One rename:
the reference's ``use_pallas`` (off by default, read by no model) is
``use_kernels`` here, on by default, as on ``MemoryController``: it routes
the model's prefill attention through kernel B6 for CUDA tensors.
``remat`` and ``remat_policy`` checkpoint each layer of the train walk
with ``torch.utils.checkpoint``, and ``loss_chunks`` each chunk of the
loss, as ``jax.checkpoint`` does in the reference; ``scan_layers`` is
carried for parity (the port's layer walk is a Python loop).

Every assigned architecture is a frozen ``ArchConfig``; every workload
shape is a ``ShapeConfig``. ``(arch, shape)`` cells drive the smoke tests,
the multi-pod dry-run and the roofline table. The memory controller is a
first-class member of the config — enabling/disabling engines re-specializes
the compiled program like the paper's synthesis parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.config import MemoryControllerConfig


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    num_shared_experts: int = 0    # qwen2-moe: always-on shared experts
    shared_d_expert: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256               # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | moe | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention
    causal: bool = True
    attn_window: Optional[int] = None      # sliding-window size (SWA archs)
    rope_theta: float = 10_000.0
    # family extensions
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    attn_every: Optional[int] = None       # hybrid: attn at layer l%attn_every==attn_offset
    attn_offset: int = 4
    moe_every: Optional[int] = None        # hybrid: MoE at l%moe_every==1
    # modality frontend stubs (audio frames / vision patches)
    modality: str = "text"                 # text | audio | vision_text
    frontend_dim: Optional[int] = None     # stub embedding feature size
    num_vision_tokens: int = 0             # vision_text: prefix length
    # numerics / memory controller
    param_dtype: str = "bfloat16"
    mc: MemoryControllerConfig = dataclasses.field(
        default_factory=MemoryControllerConfig)
    use_kernels: bool = True               # CUDA kernels (B6 in prefill)
    remat: bool = True
    # "nothing" recomputes the whole layer in backward (min memory, max
    # recompute: 3 weight-gather passes); "dots" saves matmul outputs
    # (more live memory, one fewer recompute pass). §Perf lever.
    remat_policy: str = "nothing"
    # lax.scan over layer groups (compact HLO). The dry-run's cost
    # extrapolation compiles small unrolled variants because XLA cost
    # analysis counts while bodies once regardless of trip count.
    scan_layers: bool = True
    # Chunked cross-entropy (beyond-paper optimization, §Perf): compute the
    # LM head + softmax in `loss_chunks` sequence chunks with rematerialized
    # logits, so the (B,S,V) logits tensor never exists in HBM. None = the
    # naive baseline loss.
    loss_chunks: int | None = None
    # MoE dispatch scheduler: "sort" = the paper's batch-reorder scheduler
    # (stable sort by expert/row id, positions from run offsets);
    # "cumsum" = naive GShard-style one-hot prefix scan (the baseline the
    # scheduler is compared against in §Perf).
    moe_dispatch: str = "sort"
    # Flash-attention (XLA path) block shapes — the DMA-engine staging
    # sizes. Larger kv blocks rewrite the online-softmax accumulators
    # fewer times (§Perf memory lever); smaller blocks cap live memory.
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    # Serving KV-cache storage: "param" follows param_dtype; "int8" stores
    # quantized K/V with per-(position, head) scales — halves decode cache
    # reads/footprint at ~1e-2 relative attention error (tested).
    kv_cache_dtype: str = "param"
    # citation tag for the assignment table
    source: str = ""

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.family != "ssm" and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.family in ("moe",) and self.moe is None:
            raise ValueError("moe family needs an MoESpec")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError("ssm/hybrid family needs an SSMSpec")

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: embeddings/LM head are allocated
        at the next multiple of 256 so the vocab dim shards evenly on any
        TP axis up to 256; loss masks the padding columns."""
        return -(-self.vocab_size // 256) * 256

    # --- derived sizes (used by roofline MODEL_FLOPS and memory checks) ----
    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * (h + 2 * kv) + h * hd * d
        mlp = 3 * d * f                       # SwiGLU
        per_layer = []
        for layer in range(self.num_layers):
            kind_mixer, kind_ffn = self.layer_kinds(layer)
            p = 2 * d                          # 2 RMSNorm weights
            if kind_mixer == "attn":
                p += attn
            elif kind_mixer == "mamba":
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                p += d * (2 * d_in + 2 * s.d_state + nheads)  # in_proj(z,x,B,C,dt)
                p += d_in * d                  # out_proj
                p += 2 * nheads                # A_log, D
                p += d_in                      # gated-norm weight
            if kind_ffn == "mlp":
                p += mlp
            elif kind_ffn == "moe":
                m = self.moe
                p += d * m.num_experts         # router
                p += m.num_experts * 3 * d * m.d_expert
                p += m.num_shared_experts * 3 * d * m.shared_d_expert
            per_layer.append(p)
        embed = v * d
        head = v * d                           # untied LM head
        final_norm = d
        extra = 0
        if self.modality in ("audio", "vision_text"):
            extra += (self.frontend_dim or d) * d  # connector projection
        return embed + head + final_norm + sum(per_layer) + extra

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_expert_cost = m.num_experts * 3 * self.d_model * m.d_expert
        active_expert_cost = m.top_k * 3 * self.d_model * m.d_expert
        n_moe_layers = sum(
            1 for l in range(self.num_layers)
            if self.layer_kinds(l)[1] == "moe")
        return (self.param_count()
                - n_moe_layers * (dense_expert_cost - active_expert_cost))

    def layer_kinds(self, layer: int) -> Tuple[str, str]:
        """(mixer, ffn) kinds for a layer index."""
        if self.family == "ssm":
            return "mamba", "none"            # mamba2 blocks have no FFN
        if self.family == "hybrid":
            mixer = ("attn" if layer % self.attn_every == self.attn_offset
                     else "mamba")
            ffn = "moe" if (self.moe_every and layer % self.moe_every == 1) \
                else "mlp"
            return mixer, ffn
        ffn = "moe" if self.moe is not None else "mlp"
        return "attn", ffn

    @property
    def scan_period(self) -> int:
        """Layers per scanned group (hybrid archs scan over their pattern
        period; homogeneous stacks scan layer-by-layer)."""
        if self.family == "hybrid":
            import math
            return abs(self.attn_every * self.moe_every) // math.gcd(
                self.attn_every, self.moe_every)
        return 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supported_shapes(arch: ArchConfig) -> list:
    """Which shape cells are runnable for an arch (skips per assignment:
    encoder-only has no decode; long_500k needs sub-quadratic attention)."""
    names = ["train_4k", "prefill_32k"]
    if arch.family != "encoder":
        names.append("decode_32k")
        sub_quadratic = (
            arch.family in ("ssm", "hybrid") or arch.attn_window is not None)
        if sub_quadratic:
            names.append("long_500k")
    return names
