"""dbrx-132b [moe]: 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,              # unused (all layers MoE); kept for completeness
    vocab_size=100_352,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff=10_752, every=1),
    sub_quadratic=False,
    source="hf:databricks/dbrx-base; unverified",
))
