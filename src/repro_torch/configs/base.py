"""Model configuration and registry: the port of ``repro.configs.base``,
cut to the fields and the architectures the ported path reads.

Registered: all ten architectures of the JAX package. xlstm-125m
(``configs/xlstm_125m.py``), tinyllama-1.1b (``configs/tinyllama_1_1b.py``),
the sliding-window family's h2o-danube-1.8b, gemma3-4b and
mistral-large-123b, the mixture-of-experts olmoe-1b-7b and grok-1-314b,
the Mamba2 hybrid zamba2-7b, the M-RoPE decoder qwen2-vl-7b (three-plane
positions, stubbed vision patch embeddings) and the encoder-decoder
whisper-small (stubbed audio frames, sinusoidal positions, cross-attention
decoder blocks). mistral-large-123b and grok-1-314b are served at smoke
size only: their 123B and 314B parameters fit on no one card.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_unit: Tuple[str, ...]         # repeating unit of block kinds
    head_dim: Optional[int] = None
    # attention
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    lstm_heads: int = 4                 # xLSTM heads
    # encoder-decoder (audio)
    encoder_layers: int = 0
    source_positions: int = 0           # encoder sequence length (stub frames)
    # vlm stub
    vision_tokens: int = 0              # patch embeddings provided per sample
    pos_embedding: str = "rope"         # rope | sinusoidal
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"             # activation dtype; weights are f32
    source: str = ""                    # provenance citation
    long_context: str = "swa_variant"
    long_context_window: int = 4096

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds: block_unit tiled/truncated to num_layers."""
        unit = self.block_unit
        reps = -(-self.num_layers // len(unit))
        return (unit * reps)[: self.num_layers]

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def for_long_context(self) -> "ModelConfig":
        if self.long_context == "swa_variant":
            return self.with_overrides(sliding_window=self.long_context_window)
        return self


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_MODULES = ("xlstm_125m", "tinyllama_1_1b", "h2o_danube_1_8b", "gemma3_4b",
            "mistral_large_123b", "olmoe_1b_7b", "grok_1_314b", "zamba2_7b",
            "qwen2_vl_7b", "whisper_small")


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def _ensure_imported() -> None:
    for mod in _MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_imported()
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_imported()
    return _SMOKE_REGISTRY[name]()


def list_architectures():
    _ensure_imported()
    return sorted(_REGISTRY)
