"""kimi-k2-1t-mla [moe] — BEYOND-POOL VARIANT (not an assigned cell).

The assigned kimi-k2 table row specifies GQA kv=8, but the real Kimi K2
inherits DeepSeek-V3's MLA.  This variant restores MLA (kv_rank 512, rope 64,
q_rank 1536) to quantify what the assigned GQA spec costs at decode: KV cache
per token drops from 8*112*2*2 B = 3,584 B/layer (GQA K+V) to
(512+64)*2 B = 1,152 B/layer (latent+rope) — 3.1x — and combined with the
absorbed-decode path (EXPERIMENTS.md §Perf H3) the decode cell's memory
term shrinks accordingly.
"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2501.kimi2 (+DeepSeek-V3 MLA)", "tier": "variant",
        "family": "moe"}


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-mla",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=64,
        d_ff=2048,
        vocab=163840,
        head_dim=128,
        attn_kind="mla",
        mla_kv_rank=512,
        mla_q_rank=1536,
        mla_rope_dim=64,
        n_experts=384,
        experts_per_token=8,
        n_shared_experts=1,
        first_dense_layers=1,
        supports_500k=False,
    )
