"""starcoder2-7b [dense]: GQA, RoPE; 36 heads (non-divisible by TP=16 --
GSPMD pads, see DESIGN.md section 6). [arXiv:2402.19173; hf]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    qkv_bias=True,
    mlp_bias=True,
    act="gelu",
    norm="layernorm",
    sub_quadratic=False,
    source="arXiv:2402.19173; hf",
))
