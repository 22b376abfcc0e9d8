"""qwen2-7b [dense]: GQA, QKV bias; 28 heads (non-divisible by TP=16 --
GSPMD pads). [arXiv:2407.10671; hf]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    sub_quadratic=False,
    source="arXiv:2407.10671; hf",
))
