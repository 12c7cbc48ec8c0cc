"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8 with one
shared expert; first layer dense (paper-table config). [arXiv:2501.kimi2;
unverified]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2501.kimi2", "tier": "unverified", "family": "moe"}


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,              # per-expert FFN width
        vocab=163840,
        head_dim=112,
        attn_kind="full",
        n_experts=384,
        experts_per_token=8,
        n_shared_experts=1,
        first_dense_layers=1,
        supports_500k=False,
    )
