"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias.
Command-R uses parallel attention+FFN blocks and LayerNorm (no bias),
tied embeddings, rope_theta=8M in the HF config.

A copy of `repro.configs.command_r_35b`: the port imports nothing of `repro`.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="command_r_35b",
        family="lm",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        rope_theta=8_000_000.0,
        use_bias=False,
        norm_type="layernorm",
        parallel_block=True,
        tie_embeddings=True,
    )
