"""olmoe-1b-7b [moe]: 64 experts, top-8 routing, 1B active / 7B total.

16 layers, d_model=2048, 16 heads (GQA kv=16), expert d_ff=1024,
vocab=50304. [arXiv:2409.02060]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", arch_type="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304, block_unit=("moe",),
        num_experts=64, experts_per_token=8,
        source="arXiv:2409.02060",
        long_context="swa_variant", long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", arch_type="moe",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, block_unit=("moe",),
        num_experts=4, experts_per_token=2,
        source="arXiv:2409.02060",
    )


register("olmoe-1b-7b", config, smoke_config)
