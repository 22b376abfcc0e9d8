"""internlm2-1.8b [dense]: GQA. [arXiv:2403.17297; hf]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
    sub_quadratic=False,
    source="arXiv:2403.17297; hf",
))
