"""rwkv6-3b [ssm]: Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,             # d_model / head_size(64)
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    rwkv=True,
    rwkv_head_size=64,
    use_rope=False,
    act="relu_sq",            # rwkv channel-mix uses relu^2
    sub_quadratic=True,       # linear in sequence: runs long_500k
    source="arXiv:2404.05892; hf",
))
