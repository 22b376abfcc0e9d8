"""jamba-1.5-large-398b [hybrid]: Mamba + attention 1:7 interleave
(attn_layer_period=8, offset=4), MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]"""

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,            # 9 groups of 8 (1 attn + 7 mamba each)
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24_576, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    sub_quadratic=True,       # SSM-dominant: runs long_500k
    source="arXiv:2403.19887; hf",
))
