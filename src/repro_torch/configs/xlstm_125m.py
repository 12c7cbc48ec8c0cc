"""xlstm-125m [ssm] — alternating mLSTM / sLSTM blocks (7:1-ish pattern,
d_ff=0: blocks carry internal projections). [arXiv:2405.04517; unverified]"""

from ..models.common import ModelConfig

META = {"source": "arXiv:2405.04517", "tier": "unverified", "family": "ssm"}


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        xlstm_pattern="mmmsmmmsmmms",
        supports_500k=True,     # O(1) recurrent state
    )
