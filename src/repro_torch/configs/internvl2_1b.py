"""internvl2-1b — InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821].

VLM carve-out: the vision encoder is a stub; `patch_embeds` are precomputed
(B, 256, d_model) projector outputs consumed as a prefix by the LM.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", arch_type="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655, n_prefix_patches=256, tie_embeddings=True,
    source="arXiv:2404.16821",
)
