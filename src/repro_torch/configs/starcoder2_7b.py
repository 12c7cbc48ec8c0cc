"""starcoder2-7b [dense] — GQA + RoPE code model. [arXiv:2402.19173; hf]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2402.19173", "tier": "hf", "family": "dense"}


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab=49152,
        attn_kind="full",
        mlp_act="gelu",
        supports_500k=False,
    )
