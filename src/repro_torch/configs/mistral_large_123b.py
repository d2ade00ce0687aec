"""mistral-large-123b [dense].

88 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=28672, vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", arch_type="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=28672, vocab_size=32768, block_unit=("attn",),
        head_dim=128,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
        long_context="swa_variant", long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, block_unit=("attn",), head_dim=32,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )


register("mistral-large-123b", config, smoke_config)
