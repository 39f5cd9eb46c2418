"""ChatGLM3-6B [arXiv:2406.12793; hf:THUDM/chatglm3-6b].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 — RoPE 2d, GQA.
GLM applies rotary position embedding to half of the head dimensions
("2d" RoPE) and uses RMSNorm + SwiGLU; QKV has bias, other projections none.
d_ff=13696 is the HF ffn_hidden_size (already the SwiGLU half-width).

A copy of `repro.configs.chatglm3_6b`: the port imports nothing of `repro`.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="chatglm3_6b",
        family="lm",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope_theta=10_000.0,
        rope_fraction=0.5,
        use_bias=True,  # QKV bias (GLM convention)
        norm_type="rmsnorm",
    )
