"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=1024 vocab=50304,
MoE 64 experts top-8, every layer MoE, no shared expert.

A copy of `repro.configs.olmoe_1b_7b`: the port imports nothing of `repro`.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="olmoe_1b_7b",
        family="lm",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        rope_theta=10_000.0,
        use_bias=False,
        norm_type="rmsnorm",
        n_experts=64,
        top_k=8,
        moe_interleave=1,
        n_shared_experts=0,
    )
