"""dpc_tpu_torch: Dense Predictive Coding in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``dpc_tpu`` that keeps its module layout (``core``, ``models``,
``ops``, ``train``, ``data``, ``utils``) and public channels-last shapes.
It imports neither JAX nor ``dpc_tpu``.  Entry points run on CUDA unless
the caller passes ``device="cpu"``; on CPU tensors every kernel wrapper
runs its plain PyTorch version.
"""

from dpc_tpu_torch.core.config import (DataConfig, DPCConfig,  # noqa: F401
                                       ExperimentConfig, TrainConfig)
