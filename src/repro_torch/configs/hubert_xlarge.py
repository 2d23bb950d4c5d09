"""hubert-xlarge [audio] — encoder-only transformer backbone (w2v2 arch).

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447;
unverified]. The CNN waveform feature extractor is a modality frontend STUB:
input_specs() provides precomputed frame features (dim 512) which the stub
projection maps to d_model. Training objective: masked-prediction over 504
cluster targets. Encoder-only => no decode shapes.
"""
from repro_torch.configs.base import ModelConfig, FrontendConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    attention="gqa",
    causal=False,              # bidirectional encoder
    frontend=FrontendConfig(kind="audio_frames", feature_dim=512),
    source="arXiv:2106.07447; unverified",
)
