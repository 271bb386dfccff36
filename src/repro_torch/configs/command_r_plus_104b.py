"""command-r-plus-104b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", arch_type="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000, rope_theta=75000000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
