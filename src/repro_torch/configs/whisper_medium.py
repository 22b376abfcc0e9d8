"""whisper-medium [audio]: enc-dec transformer backbone, conv frontend STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    encoder_seq=1500,         # 30s of audio at 50Hz after the (stubbed) conv
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,          # MHA (GQA kv=16)
    d_ff=4096,
    vocab_size=51_865,
    qkv_bias=True,
    mlp_bias=True,
    norm="layernorm",
    act="gelu",
    use_rope=False,           # whisper uses absolute positions
    sub_quadratic=False,
    source="arXiv:2212.04356; unverified",
))
