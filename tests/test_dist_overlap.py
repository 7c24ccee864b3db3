"""Structural evidence for the pipelined shuffle-join's overlap claim:
the pitch of make_shuffle_join_pipelined_fn is
that chunk c+1's all_to_all carries no data dependency on chunk c's
local join, so XLA's async collectives can overlap communication with
compute. Real overlap shows only in a trace on several cards, and the CPU
backend's SPMD partitioner decomposes all-to-all before the optimized
HLO (so compiled-text analysis proves nothing here); what CAN be
evidenced is the DATA-DEPENDENCE structure of the emitted program
itself, which every backend must preserve. This test walks the
shard_map body's jaxpr and asserts that the LAST probe-chunk
all_to_all's transitive input closure contains NO other all_to_all, NO
post-exchange sort and NO run expansion (scatter / cummax) — i.e. the final exchange depends only
on local slicing/packing of its own chunk, never on an earlier chunk's
exchange or on join compute. It also pins the O(1)-in-mesh-size program
contract."""
import jax
import jax.numpy as jnp
import pytest

from tpujoin.parallel.mesh import ROW_AXIS, make_mesh
from tpujoin.parallel.shuffle_join import make_shuffle_join_pipelined_fn

ROWS_PER_DEV = 4096

# the local join's own primitives: the received-side sorts and the run
# expansion (marker scatter + cummax forward fill)
JOIN_PRIMS = {"sort", "scatter", "cummax"}
EXPAND_PRIMS = {"scatter", "cummax"}


def _shard_body(ndev: int):
    """The inner jaxpr of the shard_map'd pipelined step."""
    mesh = make_mesh(ndev)
    fn = make_shuffle_join_pipelined_fn(mesh, 2048, 1024, 4096,
                                        num_chunks=2)
    n = ROWS_PER_DEV * ndev
    args = [jnp.zeros(n, jnp.int32)] * 4
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr

    def find(jx, prim):
        for eqn in jx.eqns:
            if eqn.primitive.name == prim:
                return eqn
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    r = find(inner, prim)
                    if r is not None:
                        return r
        return None

    eqn = find(jaxpr, "shard_map")
    assert eqn is not None, "no shard_map eqn found"
    body = eqn.params["jaxpr"]
    return getattr(body, "jaxpr", body)


def _prims(eqn) -> set:
    """The primitive of ``eqn`` and, through nested jit calls, every
    primitive inside it: the materialize phase is a jitted function the
    body calls, so its scatter and cummax sit one level down."""
    names = {eqn.primitive.name}
    inner = eqn.params.get("jaxpr")
    if eqn.primitive.name in ("jit", "pjit") and inner is not None:
        for e in getattr(inner, "jaxpr", inner).eqns:
            names |= _prims(e)
    return names


def _closure_eqns(body, target_eqn):
    """Equations reachable through the transitive inputs of target_eqn
    within the (flat) shard body. Nested jaxprs (fori_loop while eqns,
    jitted helpers) are opaque nodes here — conservative and sufficient:
    collectives and sorts appear as body-level eqns, and :func:`_prims`
    finds the expansion's scatter/cummax inside the jitted materialize."""
    producer = {}
    for eqn in body.eqns:
        for ov in eqn.outvars:
            producer[id(ov)] = eqn
    seen = {}
    stack = list(target_eqn.invars)
    while stack:
        v = stack.pop()
        eqn = producer.get(id(v))
        if eqn is None or id(eqn) in seen:
            continue
        seen[id(eqn)] = eqn
        stack.extend(eqn.invars)
    return list(seen.values())


def test_pipelined_final_exchange_is_independent_of_prior_join():
    body = _shard_body(len(jax.devices()))
    a2a = [e for e in body.eqns if e.primitive.name == "all_to_all"]
    # 2 per side for the build exchange + 2 per probe chunk (keys, ids)
    assert len(a2a) >= 6, f"expected >=6 all_to_alls, got {len(a2a)}"
    last = a2a[-1]
    cl = _closure_eqns(body, last)
    prims = [e.primitive.name for e in cl]
    # the final exchange legitimately depends on LOCAL pre-exchange work
    # (its own chunk's sort, the splitter-sample sorts); what would break
    # overlap is a dependency on any earlier EXCHANGE, on an earlier
    # chunk's run expansion, or on a POST-exchange sort (a sort that itself
    # consumes exchanged data — the received-side re-sorts of chunk c's
    # join)
    bad_a2a = [e for e in cl if e.primitive.name == "all_to_all"]
    bad_kernels = [e for e in cl if EXPAND_PRIMS & _prims(e)]
    bad_post_sorts = [
        e for e in cl
        if e.primitive.name == "sort"
        and any(x.primitive.name == "all_to_all"
                for x in _closure_eqns(body, e))
    ]
    assert not (bad_a2a or bad_kernels or bad_post_sorts), (
        f"final chunk exchange transitively depends on join work: "
        f"{len(bad_a2a)} exchanges, {len(bad_kernels)} expansion ops, "
        f"{len(bad_post_sorts)} post-exchange sorts — the pipeline's "
        f"overlap independence is broken")
    # sanity: the closure is not trivial — it holds the chunk's OWN local
    # packing (fori_loop while + pre-exchange sorts)
    assert (("while" in prims or "scan" in prims)
            and "sort" in prims), sorted(set(prims))


def test_first_chunk_join_does_feed_later_compute():
    """Control for the test above: the FIRST probe all_to_all must feed
    join compute downstream (sorts and the expansion consume its output)
    — proving the closure machinery actually sees join primitives when
    they are dependent."""
    body = _shard_body(len(jax.devices()))
    a2a = [e for e in body.eqns if e.primitive.name == "all_to_all"]
    first_out = {id(v) for v in a2a[0].outvars}
    # forward reachability: the join's sorts and expansion consume it
    consumed = set(first_out)
    hit = []
    for eqn in body.eqns:
        if any(id(v) in consumed for v in eqn.invars):
            consumed.update(id(v) for v in eqn.outvars)
            hit.extend(JOIN_PRIMS & _prims(eqn))
    assert {"sort"} <= set(hit) and EXPAND_PRIMS & set(hit), (
        f"join primitives downstream of the first exchange: {set(hit)}")


@pytest.mark.parametrize("pair", [(2, 8)])
def test_program_size_constant_in_mesh(pair):
    small, large = pair
    if len(jax.devices()) < large:
        pytest.skip("needs 8 emulated devices")

    def count(jx):
        total = len(jx.eqns)
        for eqn in jx.eqns:
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    total += count(getattr(inner, "jaxpr", inner))
        return total

    n_small = count(_shard_body(small))
    n_large = count(_shard_body(large))
    # fori_loop packing: program size must not grow ~linearly with P
    assert n_large <= n_small + 8, (n_small, n_large)
