"""The noise red-gate itself must fail red when fed a broken config
(VERDICT r4 #8: a gate nobody has seen fire is not a gate)."""
import os
import sys


sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

import noise  # noqa: E402


def test_margin_ok_predicate():
    # healthy config passes
    assert noise.margin_ok(6.3, 6.0)
    # intentionally-broken config: margin below floor fails red
    assert not noise.margin_ok(4.4, noise.INT_MARGIN_FLOORS["tfhepp_128bit"])
    assert not noise.margin_ok(5.9, noise.MARGIN_FLOORS["tfhepp_128bit"])
    # unknown preset (no floor) and unmeasurable margin never fail
    assert noise.margin_ok(1.0, None)
    assert noise.margin_ok(None, 6.0)


def test_floors_cover_shipping_presets():
    assert set(noise.MARGIN_FLOORS) >= {
        "tfhepp_128bit", "tfhepp_128bit_bg8", "tfhepp_80bit", "cggi19"}
    assert "tfhepp_128bit" in noise.INT_MARGIN_FLOORS


def test_int_adder_noise_measurement_smoke():
    """Run the integer-layer measurement end-to-end on TINY params
    (alpha=0: zero noise, margin reflects only the mod-switch term) and
    check the record shape the suite gate consumes."""
    import cufhe_jax.params as P
    from cufhe_jax import golden as G
    sk = G.keygen(P.TINY, seed=0)
    ek = G.make_eval_key(sk, seed=1)
    rec = noise.measure_int_adder_noise(P.TINY, backend="conv", batch=4,
                                        bits=4, ek=ek, sk=sk)
    assert rec["metric"] == "int_adder_digit_noise"
    assert rec["digit_errors"] == 0
    assert rec["next_add_margin_sigmas"] > 0
