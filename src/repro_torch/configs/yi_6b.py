"""Yi-6B [arXiv:2403.04652; hf:01-ai/Yi-6B].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 — llama-arch GQA.

A copy of `repro.configs.yi_6b`: the port imports nothing of `repro`.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="yi_6b",
        family="lm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        use_bias=False,
        norm_type="rmsnorm",
    )
