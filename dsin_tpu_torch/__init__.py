"""PyTorch/CUDA port of DSIN, beside the JAX package that stays its reference.

Module names mirror the JAX package (`models/`, `ops/`, `serve/`) so each
counterpart is easy to find. Public functions take NHWC float32 images in
[0, 255]; inside, tensors are NCHW. The patch search runs through a CUDA
kernel written for Hopper (`csrc/sifinder_argmax.cu`, bound in
`ops/sifinder_kernel.py`); the bitstream codec (`coding/`) runs its mode-3
context model through another (`csrc/probclass_front.cu`, bound in
`coding/probclass_kernel.py`) and its rANS coder in host C++
(`csrc/range_coder.cpp`).

Importing this package imports torch and numpy only: no jax, no flax and
nothing of the JAX package.
"""

from dsin_tpu_torch.config import (Config, ConfigError, parse_config,
                                   parse_config_file)
from dsin_tpu_torch.runtime import resolve_device

__all__ = ["Config", "ConfigError", "parse_config", "parse_config_file",
           "resolve_device"]
