"""JAX/XLA compute path (the analogue of the reference's bootstrap_gpu /
keyswitch_gpu / ntt_gpu CUDA layers).

Design (see docs/DESIGN.md): instead of translating the reference's 60-bit
prime-field NTT (include/ntt_gpu/*), all polynomial arithmetic is done as
*exact integer negacyclic convolution over Z_{2^32}* using int8 x int8 -> int32
matrix products on signed-byte limb decompositions of the keys. This is
bit-identical to the reference's large-modulus path (which also computes the
exact integer convolution, via NTT) and keeps the hot loop on the int8
tensor cores (cuBLAS on the GPU).
"""
from . import keys, keyswitch, limbs, ntt, poly, bootstrap  # noqa: F401
