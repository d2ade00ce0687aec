"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

24 layers, d_model=2560, 32 heads (GQA kv=8), d_ff=6912, vocab=32000,
sliding window 4096. [arXiv:2401.16818]
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", arch_type="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000, block_unit=("swa",),
        sliding_window=4096,
        source="arXiv:2401.16818",
        long_context="native",   # base config is already windowed
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, block_unit=("swa",), sliding_window=64,
        source="arXiv:2401.16818", long_context="native",
    )


register("h2o-danube-1.8b", config, smoke_config)
