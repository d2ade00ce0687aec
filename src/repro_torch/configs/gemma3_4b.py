"""gemma3-4b [dense]: 5:1 local:global attention, 128k context.

34 layers, d_model=2560, 8 heads (GQA kv=4), d_ff=10240, vocab=262144.
Repeating unit: 5 sliding-window (1024) layers then 1 global layer.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig, register

_UNIT = ("swa",) * 5 + ("attn",)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", arch_type="dense",
        num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
        d_ff=10240, vocab_size=262144, block_unit=_UNIT,
        head_dim=256, sliding_window=1024, rope_theta=1_000_000.0,
        source="hf:google/gemma-3-1b-pt",
        # global layers get the window override under long_500k
        long_context="swa_variant", long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, block_unit=("swa", "attn"),
        head_dim=64, sliding_window=64,
        source="hf:google/gemma-3-1b-pt",
    )


register("gemma3-4b", config, smoke_config)
