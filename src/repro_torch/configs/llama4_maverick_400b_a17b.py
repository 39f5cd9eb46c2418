"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1,
early fusion. Llama-4 interleaves MoE layers (every other layer routed,
`moe_interleave=2`) and adds one always-on shared expert per MoE layer —
that is how 128 top-1 experts with d_ff=8192 lands at ~400B total / ~17B
active. Early-fusion multimodality concerns the (stubbed) modality
frontend only; the backbone below is what we lower.

A copy of `repro.configs.llama4_maverick_400b_a17b`: the port imports nothing of `repro`.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llama4_maverick_400b_a17b",
        family="lm",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        rope_theta=500_000.0,
        use_bias=False,
        norm_type="rmsnorm",
        n_experts=128,
        top_k=1,
        moe_interleave=2,
        n_shared_experts=1,
    )
