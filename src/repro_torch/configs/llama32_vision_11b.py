"""llama-3.2-vision-11b [vlm]: GQA decoder with cross-attention image layers
every 5th layer; patch embeddings are a STUB (input_specs provides them).
[hf:meta-llama/Llama-3.2-11B-Vision]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    cross_attn_every=5,       # slots 4, 9, ... are cross-attention layers
    vision_tokens=1601,       # 1 CLS + 40x40 patches (stubbed frontend)
    sub_quadratic=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
))
