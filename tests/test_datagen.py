import jax
import numpy as np

from tpujoin.core import config, datagen


def test_uniform_range_and_determinism():
    k = jax.random.PRNGKey(0)
    a = np.asarray(datagen.uniform_keys(k, 10_000, 1, 100))
    b = np.asarray(datagen.uniform_keys(k, 10_000, 1, 100))
    assert a.min() >= 1 and a.max() <= 100
    np.testing.assert_array_equal(a, b)  # counter-based PRNG: reproducible
    # all values hit for a small domain
    assert len(np.unique(a)) == 100


def test_zipf_is_skewed_and_in_range():
    k = jax.random.PRNGKey(1)
    keys = np.asarray(datagen.zipf_keys(k, 50_000, 1, 1000, s=1.0))
    assert keys.min() >= 1 and keys.max() <= 1000
    # heaviest key should dominate: Zipf(1) over 1000 keys gives the top key
    # ~1/ln(1000) ~ 14% of mass; uniform would give 0.1%
    _, counts = np.unique(keys, return_counts=True)
    assert counts.max() / len(keys) > 0.05


def test_zipf_tail_distinctness():
    """f32 inverse-CDF quantizes large keys onto ~120-wide ULP buckets;
    the ULP jitter must restore distinctness in the tail: among tail draws (> 1e8) collisions should be rare, not
    near-total."""
    import jax

    keys = np.asarray(datagen.zipf_keys(jax.random.PRNGKey(3), 200_000,
                                        1, 1_000_000_000, 1.0))
    tail = keys[keys > 100_000_000]
    assert len(tail) > 5_000  # zipf(1) puts ~ln-fraction mass in the tail
    distinct = len(np.unique(tail))
    assert distinct > 0.98 * len(tail), (distinct, len(tail))


def test_make_relations_preset():
    cfg = config.PRESETS["test_small"]
    r, s = datagen.make_relations(cfg)
    assert r.num_rows == cfg.build_rows
    assert s.num_rows == cfg.probe_rows
    rk = np.asarray(r["key"])
    assert rk.min() >= cfg.key_min and rk.max() <= cfg.key_max


def test_expected_matches_model():
    cfg = config.PRESETS["test_small"]
    r, s = datagen.make_relations(cfg)
    rk, sk = np.asarray(r["key"]), np.asarray(s["key"])
    actual = sum((rk == k).sum() for k in sk[:200]) / 200 * len(sk)
    # within 3x of the uniform model (statistical check)
    assert 0.3 < actual / cfg.expected_matches < 3.0
