"""lrce_tpu_torch — the LRCE VideoQA stack in PyTorch for NVIDIA Hopper.

The port of ``lrce_tpu`` (JAX/Pallas on TPU): the same models, parameter
names and numerics, with the Pallas kernels replaced by CUDA kernels
written for sm_90a (``csrc/``). It imports torch and never JAX. This first
slice is the eval forward: ``models.e2e.LRCEModel`` and
``models.e2e.e2e_forward``.
"""

__version__ = "0.1.0"
