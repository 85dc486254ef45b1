"""PyTorch/CUDA port of ``acr_wsss_tpu`` for NVIDIA Hopper (H100).

Imports ``torch``, numpy, scipy and PIL only; nothing of JAX and nothing of
the JAX package. Entry points run on ``device="cuda"`` unless the caller
asks for the CPU, where every kernel wrapper takes its plain PyTorch
version.
"""
