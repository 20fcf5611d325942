"""rnb_tpu_torch — the PyTorch + CUDA port of rnb_tpu for NVIDIA Hopper.

The layout mirrors ``rnb_tpu`` module for module (``models/``, ``ops/``,
``data/``, ``train/``, ``utils/``). The package imports torch, numpy and the
standard library only; the JAX package is its reference in the tests.

  neural fields             rnb_tpu_torch.models.fields, .models.embedder
  volume renderer           rnb_tpu_torch.models.renderer
  dataset / cameras/lights  rnb_tpu_torch.data
  train step                rnb_tpu_torch.train.step
  kernels                   rnb_tpu_torch.ops (CUDA C++ in csrc/, built with
                            nvcc at first use, bound with ctypes)
"""

__version__ = "0.1.0"
