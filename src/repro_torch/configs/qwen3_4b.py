"""qwen3-4b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", arch_type="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B",
)
