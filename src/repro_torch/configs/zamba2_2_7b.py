"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block every 6
layers. [arXiv:2411.15242; hf]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2411.15242", "tier": "hf", "family": "hybrid"}


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        attn_kind="full",
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        attn_block_every=6,     # shared transformer block cadence
        supports_500k=True,     # O(1) SSM state
    )
