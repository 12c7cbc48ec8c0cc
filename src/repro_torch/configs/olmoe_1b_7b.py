"""olmoe-1b-7b [moe] — 64 experts top-8, fully MoE. [arXiv:2409.02060; hf]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2409.02060", "tier": "hf", "family": "moe"}


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        attn_kind="full",
        n_experts=64,
        experts_per_token=8,
        supports_500k=False,
    )
