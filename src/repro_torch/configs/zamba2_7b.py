"""zamba2-7b [hybrid]: Mamba2 backbone + shared-weight attention blocks.

81 layers, d_model=3584, 32 heads (kv=32, i.e. MHA in the shared block),
d_ff=14336 (shared block MLP), vocab=32000, ssm_state=64. Every 6th block is
the *shared* attention+MLP block (one weight set reused at every occurrence,
zamba2-style); the rest are Mamba2 blocks. [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, register

_UNIT = ("mamba2",) * 5 + ("shared_attn",)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", arch_type="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000, block_unit=_UNIT,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64,
        source="arXiv:2411.15242",
        long_context="native",   # Mamba2 dominates; shared attn gets a window
        long_context_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", arch_type="hybrid",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512, block_unit=("mamba2", "shared_attn"),
        ssm_state=16, ssm_expand=2, ssm_head_dim=32,
        source="arXiv:2411.15242", long_context="native",
    )


register("zamba2-7b", config, smoke_config)
