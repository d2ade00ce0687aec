"""tinyllama-1.1b [dense]: llama2-architecture small model.

22 layers, d_model=2048, 32 heads (GQA kv=4), d_ff=5632, vocab=32000.
[arXiv:2401.02385]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", arch_type="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        d_ff=5632, vocab_size=32000, block_unit=("attn",),
        source="arXiv:2401.02385",
        long_context="swa_variant", long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, block_unit=("attn",),
        source="arXiv:2401.02385",
    )


register("tinyllama-1.1b", config, smoke_config)
