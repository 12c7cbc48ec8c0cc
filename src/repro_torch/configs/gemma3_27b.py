"""gemma3-27b [dense] — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from ..models.common import ModelConfig

META = {"source": "hf:google/gemma-3-1b-pt", "tier": "unverified", "family": "dense"}


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab=262144,
        head_dim=128,
        attn_kind="sliding",
        sliding_window=1024,
        global_every=6,          # 5 local : 1 global
        mlp_act="gelu",
        scale_embed=True,
        tie_embeddings=True,
        max_seq_len=131072,
        supports_500k=True,      # bounded-window KV for 5/6 of layers
    )
