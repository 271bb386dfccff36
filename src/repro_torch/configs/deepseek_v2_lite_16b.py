"""deepseek-v2-lite-16b — MLA (kv_lora 512) + 64-routed/2-shared top-6 MoE
[arXiv:2405.04434]."""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=1408, vocab=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  d_ff_expert=1408),
    source="arXiv:2405.04434",
)
