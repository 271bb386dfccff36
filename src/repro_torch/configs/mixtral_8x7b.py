"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, swa_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    source="arXiv:2401.04088",
)
