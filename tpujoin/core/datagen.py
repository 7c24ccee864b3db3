"""Device-side data generation for benchmark relations.

The reference generates relations on the host in C++ with ``rand()``
(reference shared_stuff/shared.cpp:59-116, uniform keys in [1, 1e9], seeded
from time / std::random_device) and memcpys them to the device. Here
generation runs *on device* with JAX's counter-based PRNG: reproducible by
seed, no host->device transfer of the bulk data, and sharding-compatible
(each shard generates its own rows under shard_map).

Adds Zipf(s) skewed keys, which the reference names as future work
("Skewed datasets", reference projectDescription.md:26) and BASELINE.json
config 5 requires.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tpujoin.core.config import JoinConfig
from tpujoin.core.table import Table


def uniform_keys(key: jax.Array, n: int, key_min: int, key_max: int) -> jax.Array:
    """Uniform random i32 keys in [key_min, key_max], like reference
    shared.cpp:66-79 / :90-95 but counter-based and reproducible."""
    return jax.random.randint(key, (n,), key_min, key_max + 1, dtype=jnp.int32)


def zipf_keys(
    key: jax.Array, n: int, key_min: int, key_max: int, s: float = 1.0
) -> jax.Array:
    """Approximately Zipf(s)-distributed keys over [key_min, key_max].

    Inverse-CDF sampling with the continuous approximation of the zeta
    distribution: for s == 1, CDF(k) ~= ln(k)/ln(N) so k = N**u; for s != 1,
    k = ((N**(1-s) - 1) * u + 1) ** (1/(1-s)). Key 1 maps to key_min
    (the heaviest hitter), preserving rank order.

    f32 tail fidelity: the f32 inverse CDF quantizes large keys onto
    ~2^23 distinct values (ULP at k ~ 1e9 is ~120), collapsing tail draws
    onto few keys. Since the pdf is locally flat at ULP scale, the exact
    within-bucket conditional is uniform — so an integer jitter of one
    quantization bucket restores key-domain fidelity without changing the
    distribution (sampling stays in f32, the dtype JAX uses by default).
    """
    domain = key_max - key_min + 1
    ku, kj = jax.random.split(key)
    u = jax.random.uniform(ku, (n,), dtype=jnp.float32)
    if abs(s - 1.0) < 1e-6:
        k = jnp.exp(u * jnp.log(float(domain)))
    else:
        a = float(domain) ** (1.0 - s) - 1.0
        k = (a * u + 1.0) ** (1.0 / (1.0 - s))
    ki = jnp.clip(k, 1.0, float(domain)).astype(jnp.int32)
    ulp = jnp.maximum((k * jnp.float32(2.0 ** -22)).astype(jnp.int32), 1)
    jitter = (jax.random.uniform(kj, (n,), dtype=jnp.float32)
              * ulp.astype(jnp.float32)).astype(jnp.int32)
    ki = jnp.clip(ki + jitter, 1, domain)
    return (ki - 1 + key_min).astype(jnp.int32)


def make_keys(
    key: jax.Array,
    n: int,
    key_min: int,
    key_max: int,
    distribution: str = "uniform",
    zipf_s: float = 1.0,
) -> jax.Array:
    if distribution == "uniform":
        return uniform_keys(key, n, key_min, key_max)
    if distribution == "zipf":
        return zipf_keys(key, n, key_min, key_max, zipf_s)
    raise ValueError(f"unknown distribution {distribution!r}")


def make_relations(cfg: JoinConfig) -> tuple[Table, Table]:
    """Build-side relation R and probe-side relation S for a config.

    Mirrors initRelationR / initRelationS (reference shared.cpp:59-116):
    two independently-seeded key columns. Row IDs are implicit (the row
    position), matching the reference's rowID = thread index convention
    (reference join_v1.mlir:262-266).
    """
    kr, ks = jax.random.split(jax.random.PRNGKey(cfg.seed))
    r = Table({"key": make_keys(kr, cfg.build_rows, cfg.key_min, cfg.key_max,
                                cfg.distribution, cfg.zipf_s)})
    s = Table({"key": make_keys(ks, cfg.probe_rows, cfg.key_min, cfg.key_max,
                                cfg.distribution, cfg.zipf_s)})
    return r, s
