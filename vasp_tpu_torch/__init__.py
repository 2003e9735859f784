"""vasp_tpu_torch — the vascular FSI framework on PyTorch and CUDA.

The second package beside ``vasp_tpu`` (the JAX reference). It keeps the
reference's layout (mesh/, fem/, bcs/, run/, models/) so every module has
an obvious counterpart, and it never imports jax or vasp_tpu: host modules
without jax are copied, device code is rewritten on torch tensors, and the
element residual, element Jacobians, element matvec, Ruiz sweeps, banded
assembly, banded apply and flow measures run as hand-written CUDA kernels
(kernels/, csrc/) on a CUDA device.
"""
import torch

__version__ = "0.1.0"

# Every tensor constructor names its dtype; float32 appears only where the
# iterative path asks for it (Jacobians, banded factors). float32 products,
# the banded factorization's GEMMs among them, must never silently drop to
# TF32 (three decimal digits): turn it off for matmuls and cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
