"""whisper-small [audio]: encoder-decoder; conv/mel frontend stubbed.

12 encoder + 12 decoder layers, d_model=768, 12 heads (MHA), d_ff=3072,
vocab=51865, 1500 encoder frames (30 s of audio after the conv stack, which
is stubbed: ``data.lm.model_batch`` provides post-conv frame embeddings).
[arXiv:2212.04356]

Decoding runs the decoder with a self-attention KV cache plus cross-attention
K/V computed once from the encoder output (``registry.prefill_cross_cache``).
Whisper's decoder is bounded at 448 learned positions; ``long_500k`` is
skipped.
"""
from repro_torch.configs.base import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", arch_type="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51865, block_unit=("attn",),
        encoder_layers=12, source_positions=1500,
        pos_embedding="sinusoidal", tie_embeddings=True,
        source="arXiv:2212.04356",
        long_context="skip",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", arch_type="audio",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512, block_unit=("attn",),
        encoder_layers=2, source_positions=64,
        pos_embedding="sinusoidal",
        source="arXiv:2212.04356", long_context="skip",
    )


register("whisper-small", config, smoke_config)
