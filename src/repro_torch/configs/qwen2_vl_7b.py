"""qwen2-vl-7b [vlm]: M-RoPE decoder; vision encoder stubbed to patch embeds.

28 layers, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
M-RoPE splits each head's rotary half-dim (64) into (temporal=16, height=24,
width=24) sections. The ViT/merger frontend is a stub: ``data.lm.model_batch``
provides pre-projected patch embeddings. [arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", arch_type="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064, block_unit=("attn",),
        head_dim=128, mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
        vision_tokens=256,
        source="arXiv:2409.12191",
        long_context="swa_variant", long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", arch_type="vlm",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, block_unit=("attn",),
        head_dim=64, mrope_sections=(8, 12, 12), vision_tokens=16,
        source="arXiv:2409.12191",
    )


register("qwen2-vl-7b", config, smoke_config)
