"""whisper-base — encoder-decoder; conv/mel frontend is a stub
[arXiv:2212.04356]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", arch_type="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865, n_encoder_layers=6, encoder_seq=1500,
    source="arXiv:2212.04356",
)
