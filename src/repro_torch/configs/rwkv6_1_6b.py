"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536,
    rwkv=RWKVConfig(head_size=64),
    source="arXiv:2404.05892",
)
