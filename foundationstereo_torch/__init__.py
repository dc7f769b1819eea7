"""FoundationStereo on PyTorch and CUDA: the port of ``foundationstereo_tpu``
to one NVIDIA H100, with hand-written CUDA kernels for the cost-volume build,
the disparity lookup and the ViT flash attention (``ops/kernels.py``).

It imports ``torch`` and never ``jax`` or the JAX package.
"""

from foundationstereo_torch.config import ModelConfig  # noqa: F401
