"""gemma3-1b [dense] — 5:1 local:global, 128k. [hf:google/gemma-3-1b-pt; unverified]"""

from ..models.common import ModelConfig

META = {"source": "hf:google/gemma-3-1b-pt", "tier": "unverified", "family": "dense"}


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_ff=6912,
        vocab=262144,
        head_dim=256,
        attn_kind="sliding",
        sliding_window=512,
        global_every=6,
        mlp_act="gelu",
        scale_embed=True,
        tie_embeddings=True,
        max_seq_len=131072,
        supports_500k=True,
    )
