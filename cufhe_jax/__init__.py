"""cufhe_jax — TFHE gate bootstrapping in JAX (capabilities of
virtualsecureplatform/cuFHE, re-designed for JAX/XLA; runs on the GPU).

Layers (mirrors SURVEY.md §1):
  params   — runtime parameter sets (reference: TFHEpp params via CMake flags)
  golden   — NumPy bit-exact oracle (replaces the TFHEpp submodule)
  ops      — JAX/XLA compute path (blind rotate, keyswitch, polymul)
  models   — gate set + composite encrypted circuits
  parallel — mesh sharding / multi-device scale-out (replaces multi-GPU streams)
  utils    — serialization, timing
"""
from . import golden, params
from .params import (CGGI19, CONCRETE, DEFAULT, PRESETS, TFHEPP_128,
                     TFHEPP_128_BG8, TFHEPP_80, TINY, TINY_K2, GateParams)

__version__ = "0.1.0"
