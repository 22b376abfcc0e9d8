"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, fine-grained d_ff=768.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,             # decoupled from d_model/num_heads (per HF config)
    d_ff=768,                 # per-expert width (fine-grained experts)
    vocab_size=151_936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=768, every=1),
    sub_quadratic=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
