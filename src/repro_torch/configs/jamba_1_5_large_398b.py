"""jamba-1.5-large-398b — Mamba+attention 1:7 hybrid with 16-expert top-2 MoE
[arXiv:2403.19887]."""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every_n_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, attn_every_n=8),
    source="arXiv:2403.19887",
)
