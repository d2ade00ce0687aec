"""xlstm-125m [ssm]: alternating mLSTM + sLSTM blocks.

12 layers, d_model=768, 4 heads, vocab=50304 (d_ff=0: the xLSTM blocks carry
their own internal up/down projections). [arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", arch_type="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304, block_unit=("mlstm", "slstm"),
        lstm_heads=4,
        source="arXiv:2405.04517",
        long_context="native",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", arch_type="ssm",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=512, block_unit=("mlstm", "slstm"),
        lstm_heads=4,
        source="arXiv:2405.04517", long_context="native",
    )


register("xlstm-125m", config, smoke_config)
