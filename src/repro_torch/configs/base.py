"""Configuration dataclasses, the port's own copies.

The model architecture (``MoEConfig``, ``SSMConfig``, ``RGLRUConfig``,
``ModelConfig``) and ``InputShape`` are copied from
``repro.configs.base:25-170`` unchanged, so the arch files under
``repro_torch/configs/`` carry the same values (``SSMShard``,
``RGLRUShard`` and ``MoEShard``, a rank's piece on a mesh's model axis,
are the port's own); so are ``MinimaxConfig`` (:177) and ``MeshConfig``
(:255-275).  ``ModelConfig.param_count`` counts the RG-LRU gates ``wa``/``wx`` as diagonal, as the reference does;
``repro_torch.models.model.param_count`` counts the tensors.

Algorithm hyperparameters (Algorithm 1):

Same fields, defaults and string values as ``repro.configs.base.
AlgorithmConfig`` so a config carries over unchanged; only
``gossip_backend`` takes the port's values.  Churn is ported:
``topology_cycle`` is read by ``make_round_step``, and ``topology_family``,
``edge_prob``, ``client_drop_prob``, ``participation_rate`` and
``topology_seed`` parametrize the per-round samplers of
``repro_torch.core.stochastic_topology`` / ``sparse_topology`` that the
caller rides on the engine's sampler slot (``engine.with_topology``), as in
the reference.  ``gossip_compress`` is read by ``init_state`` (the EF
residuals) and ``make_round_step`` (``pallas_packed`` and ``fused_round``
take it, the others refuse it as the reference does); ``robust_trim`` by
the robust mixing impls; ``num_byzantine``, ``attack`` and
``attack_scale`` parametrize ``core.adversary.make_attack_sampler``, which
the caller rides on the engine's sampler slot with
``make_round_step(byzantine=True)``, as in the reference; ``inner_opt`` is
read nowhere, in the reference as here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------

# Block kinds a decoder stack may be composed of.
BLOCK_ATTN = "attn"            # full causal self-attention + MLP
BLOCK_SLIDING = "sliding"      # sliding-window causal attention + MLP
BLOCK_MOE = "moe"              # attention + MoE MLP
BLOCK_SSM = "ssm"              # Mamba2 SSD block (attention-free)
BLOCK_RGLRU = "rglru"          # RG-LRU recurrent block (Griffin/Hawk style)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    # d_ff of EACH expert (assigned configs give the per-expert width).
    expert_d_ff: int = 0
    router_aux_coef: float = 0.01
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    dispatch: str = "dense"  # "dense" (one-hot capacity) | "sorted" (ragged_dot)

    def expert_range(self) -> Tuple[int, int]:
        """[lo, hi): the experts whose weights a block holds (all)."""
        return 0, self.num_experts


@dataclasses.dataclass(frozen=True)
class MoEShard(MoEConfig):
    """The MoE of one rank of a client's model axis under expert
    parallelism (``dist.tensor_parallel.shard_config(expert_parallel=
    True)``): experts ``[expert_lo, expert_lo + rank_experts)``, each
    whole.  ``num_experts`` stays the model's: the router, the capacity
    and the aux loss read every expert."""
    expert_lo: int = 0
    rank_experts: int = 0

    def expert_range(self) -> Tuple[int, int]:
        return self.expert_lo, self.expert_lo + self.rank_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 128
    d_head: int = 64           # P in the SSD paper
    expand: int = 2            # d_inner = expand * d_model
    chunk: int = 64            # SSD chunk length
    d_conv: int = 4            # depthwise conv width

    def heads(self, d_model: int) -> int:
        """The SSD heads H of a block: d_inner / d_head."""
        return self.expand * d_model // self.d_head


@dataclasses.dataclass(frozen=True)
class SSMShard(SSMConfig):
    """The SSM of one rank of the serving mesh's model axis
    (``dist.tensor_parallel.shard_config``): ``rank_heads`` of the block's
    H heads, and their rank_heads·d_head channels of d_inner.  ``expand``
    stays the model's, so d_inner = expand·d_model is the whole width that
    the gated norm divides by."""
    rank_heads: int = 0

    def heads(self, d_model: int) -> int:
        return self.rank_heads


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU (RecurrentGemma) configuration."""
    lru_width: int = 0         # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn_local")
    local_window: int = 2048

    def channels(self, d_model: int) -> int:
        """The LRU channels W of a block (``lru_width``, or d_model)."""
        return self.lru_width or d_model


@dataclasses.dataclass(frozen=True)
class RGLRUShard(RGLRUConfig):
    """The RG-LRU of one rank of the serving mesh's model axis
    (``dist.tensor_parallel.shard_config``): ``rank_channels`` of the
    block's W channels.  ``lru_width`` stays the model's: the gates read
    every channel (``wa`` and ``wx`` keep their W rows)."""
    rank_channels: int = 0

    def channels(self, d_model: int) -> int:
        return self.rank_channels


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Block pattern; if empty, derived from arch_type (all-attn / all-moe / ...).
    block_pattern: Tuple[str, ...] = ()
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    rglru: RGLRUConfig = RGLRUConfig()
    # Sliding-window size used when a "sliding" block is selected (also the
    # beyond-paper long-context variant for dense archs).
    sliding_window: int = 4096
    # When > 0, full-attention blocks (attn/moe) switch to this sliding window
    # — the long_500k variant for otherwise-quadratic archs (see DESIGN.md §5).
    long_context_window: int = 0
    # Modality frontend stub: number of prefix embedding tokens supplied by
    # input_specs() (vlm: vision patches; 0 = none).
    num_prefix_tokens: int = 0
    # Audio: number of parallel codebook streams (musicgen).
    num_codebooks: int = 0
    # Source citation for the assigned config.
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length == num_layers."""
        if self.block_pattern:
            pat = self.block_pattern
        elif self.arch_type == "moe":
            pat = (BLOCK_MOE,)
        elif self.arch_type == "ssm":
            pat = (BLOCK_SSM,)
        elif self.arch_type == "hybrid":
            pat = self.rglru.block_pattern
        else:
            pat = (BLOCK_ATTN,)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.blocks():
            if kind in (BLOCK_ATTN, BLOCK_SLIDING, BLOCK_MOE):
                attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                if self.qkv_bias:
                    attn += (n_q + 2 * n_kv) * hd
                total += attn
                if kind == BLOCK_MOE:
                    m = self.moe
                    total += d * m.num_experts  # router
                    total += m.num_experts * 3 * d * m.expert_d_ff
                else:
                    total += 3 * d * self.d_ff  # gate/up/down
                total += 2 * d  # norms
            elif kind == BLOCK_SSM:
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.d_head
                total += d * (2 * d_in + 2 * s.d_state + nheads)  # in_proj-ish
                total += d_in * d  # out_proj
                total += d_in * s.d_conv + 2 * nheads + d  # conv, A, D, norm
            elif kind == "attn_local":
                attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                total += attn + 3 * d * self.d_ff + 2 * d
            elif kind == BLOCK_RGLRU:
                w = self.rglru.lru_width or d
                total += d * w * 2 + w * d  # in (x,gate) + out
                total += 3 * w  # recurrent/input gates diag-ish + Λ
                total += 3 * d * self.d_ff + 2 * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        m = self.moe
        dense_like = self.param_count()
        n_moe = sum(1 for k in self.blocks() if k == BLOCK_MOE)
        unused = n_moe * (m.num_experts - m.top_k) * 3 * self.d_model * m.expert_d_ff
        return dense_like - unused


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class MinimaxConfig:
    objective: str = "dro"     # quadratic | dro | adversarial
    # DRO: number of loss groups (= d_y); strong-concavity modulus mu
    num_groups: int = 8
    mu: float = 1.0
    # adversarial: perturbation scale
    adv_scale: float = 0.1


# ---------------------------------------------------------------------------
# Mesh / sharding (reference :255-275.  The serving mesh, which executes
# its model axis, reads no MeshConfig: launch.mesh.serve_mesh takes its
# sizes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    num_clients: int = 4       # clients axis of the logical mesh
    fsdp: int = 4
    model: int = 16
    # parameter layout within a client: "fsdp2d" shards weights over
    # (fsdp, model); "replicated" keeps them whole (small models)
    param_mode: str = "fsdp2d"
    moe_expert_parallel: bool = False
    # the reference's switch between all-gathering the seq-sharded
    # residual before attention and an all-to-all to q split by heads
    # (Megatron-SP style).  In the port's Megatron layout q is always
    # split by heads after the sequence's gather, and the context returns
    # to the sequence split through attn_proj's reduce-scatter: the layout
    # this switch asks GSPMD for.  So both values run that one program.
    attn_heads_sharding: bool = False
    # residual sharding: "batch_seq" (fsdp, model: the sequence split over
    # model, dist.tensor_parallel.SeqSplit) or "batch" (fsdp only: the
    # residual whole on every model rank)
    residual_mode: str = "batch_seq"
    # activation checkpointing of each unit of the block pattern in
    # training, as the reference's default: a unit keeps only its input
    # for the backward, which runs the unit again under torch.func.vjp
    # (models.transformer.UnitRemat; torch.utils.checkpoint's saved-tensor
    # hooks do not run under the torch.func.grad that takes the clients'
    # gradients)
    remat: bool = True

    @property
    def devices_needed(self) -> int:
        return self.num_clients * self.fsdp * self.model


# ---------------------------------------------------------------------------
# K-GT-Minimax algorithm hyperparameters (Algorithm 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    algorithm: str = "kgt_minimax"  # kgt_minimax | dsgda | local_sgda | gt_gda
    num_clients: int = 4
    local_steps: int = 2            # K
    eta_cx: float = 1e-3            # local stepsize for x
    eta_cy: float = 1e-2            # local stepsize for y
    eta_sx: float = 1.0             # communication stepsize for x
    eta_sy: float = 1.0             # communication stepsize for y
    topology: str = "ring"          # ring | torus | full | exp | star
    # Gossip lowering: "dense" (W-contraction per leaf), "ring" (roll),
    # "fused_dense"/"fused_ring" (Δ and θ stacked into one mix per leaf),
    # "pallas_packed" (whole state packed to (n, D), fused epilogue kernel —
    # the name is kept from the JAX package so configs carry over),
    # "sparse_packed" (the packed epilogue with W as neighbor lists, in the
    # neighbor-gather kernel: the path past 512 clients), "fused_round"
    # (whole round in one kernel call), and the robust aggregations
    # "coord_median" / "trimmed_mean" and their "sparse_*" neighbor-gather
    # forms (Byzantine-tolerant; see core.mixing.ROBUST_IMPLS).
    mixing_impl: str = "dense"
    # Backend for the packed kernels: "auto" (the CUDA kernel for CUDA
    # tensors, the plain PyTorch version for CPU tensors), "kernel" (the
    # CUDA kernel; CPU tensors raise), or "torch" (the plain version; CUDA
    # tensors raise).
    gossip_backend: str = "auto"
    gossip_dtype: str = "float32"   # "bfloat16" narrows the gossip operands
    gossip_compress: Optional[str] = None   # "bf16" | "int8" (EF compression)
    inner_opt: str = "sgd"
    correction_dtype: str = "float32"
    topology_cycle: Tuple[str, ...] = ()
    topology_family: str = "static"
    edge_prob: float = 0.5
    client_drop_prob: float = 0.3
    participation_rate: float = 1.0
    topology_seed: int = 0
    num_byzantine: int = 0
    attack: str = "honest"
    attack_scale: float = 1.0
    robust_trim: int = 1
