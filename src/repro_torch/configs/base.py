"""Model configuration and registry: the port of ``repro.configs.base``,
cut to the fields and the architectures the ported path reads.

Registered so far: xlstm-125m (``configs/xlstm_125m.py``, consensus
training) and tinyllama-1.1b (``configs/tinyllama_1_1b.py``, serving). The
other architectures of the JAX package wait for their block kinds (MoE,
Mamba2, encoder-decoder, sliding-window attention) to be ported
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | ...
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
    lstm_heads: int = 4                 # xLSTM heads
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

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_MODULES = ("xlstm_125m", "tinyllama_1_1b")


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
