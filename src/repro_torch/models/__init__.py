"""repro_torch.models: the dense and MoE transformer families on PyTorch.

``build(cfg, device)`` gives a ``Model`` (``models.registry``); its layers
are ``models.layers``, ``models.attention`` and ``models.moe`` (with the
coded expert FFN), and ``models.convert`` carries the JAX package's weights
across as plain arrays.
"""

from repro_torch.models.registry import Model, build

__all__ = ["Model", "build"]
