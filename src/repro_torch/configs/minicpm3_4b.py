"""minicpm3-4b [dense] — MLA attention. [hf:openbmb/MiniCPM3-4B; hf]"""

from ..models.common import ModelConfig

META = {"source": "hf:openbmb/MiniCPM3-4B", "tier": "hf", "family": "dense"}


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        head_dim=64,
        attn_kind="mla",
        mla_kv_rank=256,
        mla_q_rank=768,
        mla_rope_dim=32,
        supports_500k=False,  # MLA is full attention over the whole context
    )
