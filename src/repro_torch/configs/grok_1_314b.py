"""grok-1-314b [moe]: 8 experts, top-2 routing.

64 layers, d_model=6144, 48 heads (GQA kv=8), expert d_ff=32768,
vocab=131072. [hf:xai-org/grok-1]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", arch_type="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, vocab_size=131072, block_unit=("moe",),
        num_experts=8, experts_per_token=2,
        source="hf:xai-org/grok-1",
        long_context="swa_variant", long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-smoke", arch_type="moe",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, block_unit=("moe",),
        num_experts=4, experts_per_token=2,
        source="hf:xai-org/grok-1",
    )


register("grok-1-314b", config, smoke_config)
