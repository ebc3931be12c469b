"""gravinv3dhmc — 3-D gravity/magnetic inversion on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of
ChuWeiEr/GravInv3DHMC: closed-form prism and adaptive tesseroid forward
operators building dense device-resident sensitivity matrices, HMC/NUTS
sampling with chains vmapped into matmul-sized batches, deterministic CG and
bootstrap inversion, wavelet kernel compression, and multi-chip scaling via
``jax.sharding`` meshes.
"""

__version__ = "0.1.0"

import jax as _jax

# Host-side f64 (kernel construction, CG parity) needs x64; device hot paths
# cast explicitly to f32/bf16.
_jax.config.update("jax_enable_x64", True)

from . import constants  # noqa: F401
from .config import HMCConfig, load_setpmts  # noqa: F401
