"""command-r-35b [dense]: GQA, no-bias, 256k vocab -- the largest C = A^T B
(lm head) among the assigned archs, and the primary coded-matmul showcase.
[hf:CohereForAI/c4ai-command-r-v01]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    vocab_size=256_000,
    norm="layernorm",
    tie_embeddings=True,      # command-r ties input/output embeddings
    sub_quadratic=False,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
))
