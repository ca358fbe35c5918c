"""Config dataclasses + the arch registry (LM, GNN, recsys, seqrec).

A framework-free copy of the reference's ``configs/base.py``: ``PQConfig``,
``MoEConfig``, ``AttentionConfig``, ``LMConfig``, ``SeqRecConfig``,
``RecsysConfig``, ``GNNConfig``, ``ArchConfig`` and the shape lists.
Field names, defaults and validation are unchanged, so a config built
here describes the same model as its namesake in the reference, and
``list_archs()`` returns the reference's ids in the reference's order.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

#: Largest codebook width each storage dtype can index.
CODE_DTYPE_CAPACITY = {"int8": 128, "uint8": 256, "int16": 32_768,
                       "uint16": 65_536, "int32": 2 ** 31 - 1}


def min_code_dtype(b: int) -> str:
    """Narrowest supported storage dtype for a codebook of width ``b``."""
    for name in ("uint8", "uint16", "int32"):
        if b <= CODE_DTYPE_CAPACITY[name]:
            return name
    raise ValueError(f"b={b} exceeds int32 code storage")


@dataclass(frozen=True)
class PQConfig:
    """Sub-item-id decomposition (RecJPQ) of a large id space.

    The seed/bound/grouping/super-tile fields configure the pruned cascade,
    which this package does not serve yet; they are kept so that a config
    round-trips unchanged between the two packages."""

    m: int = 8
    b: int = 256
    assign: str = "svd"
    code_dtype: str = "int32"
    seed_policy: str = "greedy"
    seed_tiles: int = 2
    seed_max_tiles: int = 16
    seed_stab_tol: float = 0.05
    bound_backend: str = "bitmask"
    query_grouping: bool = False
    n_groups: int = 8
    super_factor: int = 0

    def __post_init__(self):
        if self.b > 2 ** 16:
            raise ValueError("b > 65536 not supported (codes stored <= int32)")
        cap = CODE_DTYPE_CAPACITY.get(self.code_dtype)
        if cap is None:
            raise ValueError(f"unsupported code_dtype {self.code_dtype!r}; "
                             f"one of {sorted(CODE_DTYPE_CAPACITY)}")
        if self.b > cap:
            raise ValueError(
                f"b={self.b} does not fit code_dtype={self.code_dtype!r} "
                f"(max {cap}); use {min_code_dtype(self.b)!r}")
        if self.seed_policy not in ("greedy", "adaptive"):
            raise ValueError(f"unknown seed_policy {self.seed_policy!r}; "
                             "one of ('greedy', 'adaptive')")
        if not 1 <= self.seed_tiles <= self.seed_max_tiles:
            raise ValueError(
                f"need 1 <= seed_tiles ({self.seed_tiles}) <= "
                f"seed_max_tiles ({self.seed_max_tiles})")
        if self.seed_stab_tol <= 0:
            raise ValueError("seed_stab_tol must be positive")
        if self.bound_backend not in ("bitmask", "range"):
            raise ValueError(
                f"unknown bound_backend {self.bound_backend!r}; "
                "one of ('bitmask', 'range')")
        if self.bound_backend == "range" and self.b > 2 ** 15:
            raise ValueError(
                f"bound_backend='range' stores int16 code ranges; "
                f"b={self.b} exceeds int16 — use bound_backend='bitmask'")
        if self.n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {self.n_groups}")
        if self.super_factor < 0 or self.super_factor == 1:
            raise ValueError(
                f"super_factor must be 0 (no super level) or >= 2, got "
                f"{self.super_factor}")
        if self.super_factor > 1 and self.query_grouping:
            raise ValueError(
                "super_factor > 1 and query_grouping are mutually exclusive")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # Sliding-window mix: every ``local_global_ratio``+1-th layer is global,
    # the rest are local with window ``window``.  0 => all layers global.
    window: int = 0
    local_global_ratio: int = 0

    def layer_is_global(self, layer_idx: int) -> bool:
        if self.local_global_ratio <= 0 or self.window <= 0:
            return True
        return (layer_idx + 1) % (self.local_global_ratio + 1) == 0


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attention: AttentionConfig
    act: str = "silu"         # silu | gelu | relu | sqrelu
    gated_mlp: bool = True    # GLU-style two-matrix up-projection
    moe: Optional[MoEConfig] = None
    moe_impl: str = "dense"   # dense (GShard one-hot) | sort (gather/scatter)
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = True
    causal: bool = True       # False => encoder-style
    # PQ-compressed unembedding for decode-time vocab scoring.
    pq_head: Optional[PQConfig] = PQConfig()
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    @property
    def q_dim(self) -> int:
        return self.attention.n_heads * self.attention.head_dim

    @property
    def kv_dim(self) -> int:
        return self.attention.n_kv_heads * self.attention.head_dim

    def _attn_params(self) -> int:
        return (self.d_model * (self.q_dim + 2 * self.kv_dim)
                + self.q_dim * self.d_model)

    def _emb_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        n_mat = 3 if self.gated_mlp else 2
        if self.moe is None:
            ffn = n_mat * self.d_model * self.d_ff
        else:
            ffn = (self.moe.n_experts * n_mat * self.d_model
                   * self.moe.d_ff_expert)
            ffn += self.d_model * self.moe.n_experts  # router
            ffn += (self.moe.n_shared * n_mat * self.d_model
                    * self.moe.d_ff_expert)
        return self.n_layers * (self._attn_params() + ffn) \
            + self._emb_params()

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        n_mat = 3 if self.gated_mlp else 2
        ffn = ((self.moe.top_k + self.moe.n_shared) * n_mat * self.d_model
               * self.moe.d_ff_expert)
        ffn += self.d_model * self.moe.n_experts
        return self.n_layers * (self._attn_params() + ffn) \
            + self._emb_params()


@dataclass(frozen=True)
class SeqRecConfig:
    name: str
    backbone: str              # sasrec | bert4rec
    n_items: int
    d_model: int = 512
    n_blocks: int = 2
    n_heads: int = 8
    d_ff: int = 1024
    max_seq_len: int = 200
    dropout: float = 0.0
    pq: PQConfig = field(default_factory=PQConfig)
    dtype: str = "float32"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"
    n_negatives: int = 256
    gbce_t: float = 0.75
    # Default scoring route for serving (retrieval_head.TOP_ITEMS_METHODS).
    serve_method: str = "pqtopk"


@dataclass(frozen=True)
class RecsysConfig:
    """The CTR/retrieval family: DCN-v2, BST, DIEN and FM."""

    name: str
    kind: str                  # dcn | bst | dien | fm
    n_dense: int = 0
    n_sparse: int = 26
    embed_dim: int = 16
    table_rows: Tuple[int, ...] = ()   # one entry per sparse field
    mlp: Tuple[int, ...] = ()
    n_cross_layers: int = 0
    seq_len: int = 0           # behaviour-sequence length (bst / dien)
    n_blocks: int = 0
    n_heads: int = 0
    gru_dim: int = 0           # dien
    n_items: int = 1_000_000   # retrieval catalogue for retrieval_cand
    pq: Optional[PQConfig] = field(default_factory=PQConfig)
    dtype: str = "float32"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"

    def total_rows(self) -> int:
        return sum(self.table_rows)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"
    sample_sizes: Tuple[int, ...] = (25, 10)
    n_classes: int = 41
    dtype: str = "float32"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape x step-kind) cell of the reference's dry-run matrix."""

    name: str
    kind: str
    dims: Any = field(default_factory=dict)
    skip_reason: str = ""


def lm_shapes(*, sub_quadratic: bool, decoder: bool = True
              ) -> Tuple[ShapeSpec, ...]:
    encoder_skip = "encoder-only arch: no autoregressive decode"
    return (
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill",
                  {"seq_len": 32_768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode",
                  {"seq_len": 32_768, "global_batch": 128},
                  skip_reason="" if decoder else encoder_skip),
        ShapeSpec(
            "long_500k", "decode", {"seq_len": 524_288, "global_batch": 1},
            skip_reason="" if (sub_quadratic and decoder) else (
                "pure full-attention arch: no sub-quadratic mechanism "
                "(DESIGN.md §4)" if decoder else encoder_skip)),
    )


def gnn_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("full_graph_sm", "train",
                  {"n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433,
                   "n_classes": 7}),
        ShapeSpec("minibatch_lg", "train",
                  {"n_nodes": 232_965, "n_edges": 114_615_892,
                   "batch_nodes": 1_024, "fanout": (15, 10), "d_feat": 602,
                   "n_classes": 41}),
        ShapeSpec("ogb_products", "train",
                  {"n_nodes": 2_449_029, "n_edges": 61_859_140,
                   "d_feat": 100, "n_classes": 47}),
        ShapeSpec("molecule", "train",
                  {"n_nodes": 30, "n_edges": 64, "graph_batch": 128,
                   "d_feat": 16, "n_classes": 2}),
    )


def seqrec_shapes(n_items: int) -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_seq", "train", {"global_batch": 4096, "seq_len": 200}),
        ShapeSpec("serve_users", "retrieval",
                  {"global_batch": 2048, "seq_len": 200,
                   "n_candidates": n_items}),
    )


def recsys_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_batch", "train", {"global_batch": 65_536}),
        ShapeSpec("serve_p99", "serve", {"global_batch": 512}),
        ShapeSpec("serve_bulk", "serve", {"global_batch": 262_144}),
        ShapeSpec("retrieval_cand", "retrieval",
                  {"global_batch": 1, "n_candidates": 1_000_000}),
    )


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str
    model: Any
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}")


_REGISTRY = {
    "qwen2.5-14b": "qwen2_5_14b",
    "nemotron-4-340b": "nemotron_4_340b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "graphsage-reddit": "graphsage_reddit",
    "dcn-v2": "dcn_v2",
    "bst": "bst",
    "dien": "dien",
    "fm": "fm",
    # the paper's own models
    "sasrec-recjpq": "sasrec_recjpq",
    "gbert4rec-recjpq": "gbert4rec_recjpq",
}


def list_archs() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def _module(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()


__all__ = [
    "PQConfig", "CODE_DTYPE_CAPACITY", "min_code_dtype", "MoEConfig",
    "AttentionConfig", "LMConfig", "SeqRecConfig", "RecsysConfig",
    "GNNConfig", "ShapeSpec", "ArchConfig", "lm_shapes", "seqrec_shapes",
    "recsys_shapes", "gnn_shapes", "list_archs", "get_config",
    "get_reduced",
]
