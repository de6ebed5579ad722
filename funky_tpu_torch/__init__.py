"""funky_tpu_torch — the PyTorch/CUDA port of funky_tpu.

Each module mirrors the `funky_tpu` module of the same name and cites the
JAX function it ports (file:line). The JAX package is the reference: the
tests in `tests/test_torch_*.py` feed both packages the same numpy inputs.

Conventions of the port:
- plain functions on tensors; every tensor is created on an explicit
  device (the device of an input, or a `device=` argument) — there is no
  global device; entry points that make tensors default to "cuda";
- dataclasses / NamedTuples of tensors take the place of pytrees;
- eager PyTorch, no `torch.compile`; the hand-written kernels are the two
  tile rasters (`csrc/raster.cu`: K1 table, K2 pre-gathered rows;
  `ops/raster_cuda.py`) and the row-gather probe (`csrc/gather.cu`,
  `ops/gather_cuda.py`), built by `ops/cuda_build.py`;
- `lax.cond` capacity fallbacks become host branches
  (`ops/compact.py::host_cond`, counted);
- `jax.lax.optimization_barrier` has no counterpart and is dropped.

This package never imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Full fp32 products everywhere, as funky_tpu/__init__.py:41-46 forces for
# XLA: TF32 keeps ~3 decimal digits, which NaNs the cascade fit (far-plane
# corners cancel) and flips shadow compares.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
