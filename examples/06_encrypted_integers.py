"""Encrypted integers: arithmetic beyond single gates.

The reference evaluates one Boolean gate per bootstrap; arithmetic means
netlists (an 8-bit add is ~40 gate bootstraps). The integer layer encodes
radix digits in the torus and uses the multi-output programmable bootstrap
(PBSmanyLUT): the sum digit AND the carry come out of ONE blind rotation,
so an adder costs one bootstrap per bit — and the whole ripple chain is a
single fused dispatch (a lax.scan inside one XLA program).

Run:  python examples/06_encrypted_integers.py    # TINY params, CPU-fast
"""
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")   # TINY demo: CPU is plenty

from cufhe_jax import TINY, golden as G
from cufhe_jax.models import (Context, IntContext, decrypt_bits,
                              decrypt_uint, encrypt_uint)

rng = np.random.default_rng(23)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)
ictx = IntContext(Context(ek))

# --- client: encrypt two batches of 8-bit integers ------------------------
xs, ys = [200, 13, 77, 255], [100, 29, 77, 1]
x = encrypt_uint(xs, 8, sk, rng=rng)
y = encrypt_uint(ys, 8, sk, rng=rng)
print(f"x = {xs}, y = {ys}  (each digit a TLWE ciphertext)")

# --- server: arithmetic without decrypting --------------------------------
ok = 0
s = ictx.add(x, y)                      # one dispatch, 1 bootstrap/bit
d = ictx.sub(x, y)
ge = ictx.ge(x, y)
eq = ictx.eq(x, y)

got_s = decrypt_uint(s, sk)
got_d = decrypt_uint(d, sk)
got_ge = decrypt_bits(ge, sk).tolist()
got_eq = decrypt_bits(eq, sk).tolist()
want_s = [(a + b) % 256 for a, b in zip(xs, ys)]
want_d = [(a - b) % 256 for a, b in zip(xs, ys)]
want_ge = [int(a >= b) for a, b in zip(xs, ys)]
want_eq = [int(a == b) for a, b in zip(xs, ys)]

for name, got, want in (("x+y", got_s, want_s), ("x-y", got_d, want_d),
                        ("x>=y", got_ge, want_ge), ("x==y", got_eq,
                                                    want_eq)):
    match = got == want
    ok += match
    print(f"{name}: {got}  expected {want}  {'OK' if match else 'WRONG'}")

assert ok == 4

# --- division: restoring divmod, the whole loop one fused dispatch --------
xs4, ys4 = [13, 9], [3, 4]
q, r = ictx.divmod_(encrypt_uint(xs4, 4, sk, rng=rng),
                    encrypt_uint(ys4, 4, sk, rng=rng))
got_q, got_r = decrypt_uint(q, sk), decrypt_uint(r, sk)
print(f"divmod({xs4}, {ys4}) = {got_q} rem {got_r}")
assert got_q == [a // b for a, b in zip(xs4, ys4)]
assert got_r == [a % b for a, b in zip(xs4, ys4)]

# --- encrypted-amount barrel shift -----------------------------------------
vals, amts = [0b0110, 0b1001], [1, 2]
sh = ictx.shift_left(encrypt_uint(vals, 4, sk, rng=rng),
                     encrypt_uint(amts, 2, sk, rng=rng))
got_sh = decrypt_uint(sh, sk)
print(f"{vals} << {amts} (amounts encrypted) = {got_sh}")
assert got_sh == [(v << s) & 0xF for v, s in zip(vals, amts)]

print("all encrypted integer results correct")
