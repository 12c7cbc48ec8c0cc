"""qwen2-vl-7b [vlm] — M-RoPE, dynamic-resolution vision (frontend stubbed:
input_specs() delivers precomputed patch embeddings). [arXiv:2409.12191; hf]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2409.12191", "tier": "hf", "family": "vlm"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152064,
        head_dim=128,
        attn_kind="full",
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),
        frontend="vision_stub",
        frontend_dim=3584,
        supports_500k=False,
    )
