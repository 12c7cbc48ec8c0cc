"""musicgen-large [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is stubbed (input_specs() provides frame embeddings).
[arXiv:2306.05284; hf]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2306.05284", "tier": "hf", "family": "audio"}


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        attn_kind="full",
        mlp_act="gelu",
        frontend="audio_stub",
        frontend_dim=2048,
        supports_500k=False,
    )
