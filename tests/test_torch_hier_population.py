"""The hierarchical tier's population state of the PyTorch port
(``repro_torch.hier.population`` and ``repro_torch.hier.sampling``) against
the JAX reference, on the CPU.

The reference's chunked solver imports ``jax.experimental.enable_x64``,
which this JAX lacks; JAX has ``jax.enable_x64(True)`` as a context
manager instead.  A module-scoped fixture sets the missing name to it in
this test process only, and takes it away after the module, so the
reference's own solver runs here and no file of the reference changes.

Held to:

  * bit for bit: `shard_ranges` and its refusals, the sampling stream,
    `parity_reweight`, `population_delay_arrays`, `nodes_for_range`,
    `return_prob`, and the chunked trace (`generate_trace_chunked`,
    `iter_trace_chunks`) at the default stripe and at a small one, block
    sizes one below, at and one above the stripe and n;
  * the port's chunked solver against the reference's chunked solver: t*
    within 2e-6 (1 + t*) and loads within 1e-4 (the allocator contract),
    and t* bit-equal where these sizes give it (they do); with a server
    node, on asymmetric links, and the refusals;
  * the port's chunked solver against itself: bit-identical across block
    sizes 1, 127, 128, 129 and n.
"""
import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFL
from repro.core.delay_model import NodeDelayParams as RefNode
from repro.hier import population as ref_pop
from repro.hier import sampling as ref_sampling
from repro.hier import topology as ref_topology
from repro.net.channel import CHANNEL_PROFILES as REF_PROFILES

from repro_torch.config import FLConfig
from repro_torch.core.delay_model import NodeDelayParams
from repro_torch.hier import population as pop
from repro_torch.hier import sampling
from repro_torch.hier import topology
from repro_torch.net.channel import CHANNEL_PROFILES

N = 300
CAP = 4.0
M = 900.0
U_MAX = 60.0
TRACE_FIELDS = ("mu_mult", "tau_mult", "p_down", "p_up", "active")
# fewer solver iterations where only partitions or packages are compared
# at equal settings (the contract holds for any fixed iteration counts)
LIGHT = dict(n_golden=20, n_golden_search=10, n_bisect=16)


@pytest.fixture(scope="module", autouse=True)
def x64_shim():
    """``jax.experimental.enable_x64`` for the reference's solver, in this
    module only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's float64 solvers run many small CPU ops: one intra-op
    thread each keeps parallel test workers from oversubscribing the
    cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl(mod, n=N, seed=3):
    # bounded heterogeneity at population sizes: the per-client geometric
    # knobs re-exponentiated to span the same range at any n
    return mod(n_clients=n, delta=0.2, seed=seed,
               rate_decay=0.95 ** (12.0 / n), mac_decay=0.8 ** (12.0 / n))


@pytest.fixture(scope="module")
def prm():
    return pop.population_delay_arrays(_fl(FLConfig), 16)


# ----------------------------------------------------------- shards, sampling
@pytest.mark.parametrize("n,shards", [(10, 3), (6, 6), (7, 1), (101, 8),
                                      (12, 5), (1000, 7)])
def test_shard_ranges_match_reference(n, shards):
    assert topology.shard_ranges(n, shards) == \
        ref_topology.shard_ranges(n, shards)


@pytest.mark.parametrize("n,shards", [(10, 0), (3, 4), (10, True),
                                      (10, 2.0)])
def test_shard_ranges_refusals_match_reference(n, shards):
    for mod in (ref_topology, topology):
        with pytest.raises(ValueError, match="hier_shards") as info:
            mod.shard_ranges(n, shards)
    with pytest.raises(ValueError) as ref_info:
        ref_topology.shard_ranges(n, shards)
    assert str(info.value) == str(ref_info.value)


@pytest.mark.parametrize("f", [1.0, 0.6, 0.25, 0.01])
def test_sampling_stream_bit_identical(f):
    """Cohorts and stream positions of the port's stream equal the
    reference's, block after block."""
    assert sampling.SAMPLE_SEED_OFFSET == ref_sampling.SAMPLE_SEED_OFFSET
    got_rng, want_rng = sampling.sampling_rng(3), ref_sampling.sampling_rng(3)
    for rounds, n in ((5, 32), (1, 7), (3, 1000)):
        got = sampling.sample_cohort_rows(got_rng, rounds, n, f)
        want = ref_sampling.sample_cohort_rows(want_rng, rounds, n, f)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got_rng.bit_generator.state == want_rng.bit_generator.state


@pytest.mark.parametrize("m,r,f", [(100.0, 60.0, 1.0), (100.0, 60.0, 0.5),
                                   (100.0, 100.0, 0.5), (48.0, 20.5, 0.6),
                                   (1e6, 3.3e5, 0.25)])
def test_parity_reweight_bit_identical(m, r, f):
    assert sampling.parity_reweight(m, r, f) == \
        ref_sampling.parity_reweight(m, r, f)


@pytest.mark.parametrize("f", [0.0, -0.1, 1.5])
def test_parity_reweight_refusals(f):
    for mod in (ref_sampling, sampling):
        with pytest.raises(ValueError, match="sample_fraction"):
            mod.parity_reweight(100.0, 60.0, f)


# --------------------------------------------------------------- deployment
@pytest.mark.parametrize("n,d,payload", [(N, 16, None), (12, 12, None),
                                         (50, 20, 7)])
def test_population_delay_arrays_bit_identical(n, d, payload):
    got = pop.population_delay_arrays(_fl(FLConfig, n), d, payload)
    want = ref_pop.population_delay_arrays(_fl(RefFL, n), d, payload)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_nodes_for_range_and_oracle_match_reference(prm):
    got = pop.nodes_for_range(prm, 37, 61)
    want = ref_pop.nodes_for_range(prm, 37, 61)
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert [vars(g) for g in pop._oracle_nodes(_fl(FLConfig), 16)] == \
        [vars(w) for w in ref_pop._oracle_nodes(_fl(RefFL), 16)]
    assert [vars(g) for g in pop.population_nodes(_fl(FLConfig), 16, 3, 9)] \
        == [vars(w) for w in ref_pop.population_nodes(_fl(RefFL), 16, 3, 9)]
    # asymmetric entries come back with their uplink fields
    asym = {k: v.copy() for k, v in prm.items()}
    asym["tau_up"] = asym["tau_up"] * 2.0
    assert [vars(g) for g in pop.nodes_for_range(asym, 0, 3)] == \
        [vars(w) for w in ref_pop.nodes_for_range(asym, 0, 3)]


@pytest.mark.parametrize("t", [0.004, 0.0088, 0.02, 1.0])
def test_return_prob_bit_identical(prm, t):
    loads = np.arange(N) % 5
    np.testing.assert_array_equal(pop.return_prob(prm, 11, 250, t, loads[11:250]),
                                  ref_pop.return_prob(prm, 11, 250, t,
                                                      loads[11:250]))


def test_return_prob_refuses_asymmetric(prm):
    bad = {k: v.copy() for k, v in prm.items()}
    bad["tau_up"] = bad["tau_up"] * 2.0
    with pytest.raises(NotImplementedError, match="reciprocal"):
        pop.return_prob(bad, 0, 4, 1.0, np.ones(4))


# ------------------------------------------------------------ chunked trace
def _traces_equal(got, want):
    for field in TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.fixture(scope="module")
def big_prm():
    """A population past one default trace stripe (1024 clients)."""
    return pop.population_delay_arrays(_fl(FLConfig, 1100), 16)


@pytest.mark.parametrize("block_size", [None, 1023, 1024, 1025, 1099, 1100,
                                        1101])
def test_chunked_trace_default_stripe_bit_identical(big_prm, block_size):
    got = pop.generate_trace_chunked(big_prm, CHANNEL_PROFILES["drift_churn"],
                                     3, seed=11, block_size=block_size)
    want = ref_pop.generate_trace_chunked(big_prm, REF_PROFILES["drift_churn"],
                                          3, seed=11, block_size=block_size)
    _traces_equal(got, want)
    # and the one-shot trace, whatever the block size
    _traces_equal(got, pop.generate_trace_chunked(
        big_prm, CHANNEL_PROFILES["drift_churn"], 3, seed=11))


@pytest.mark.parametrize("block_size", [3, 4, 5, 29, 30, 31])
def test_chunked_trace_small_stripe_bit_identical(block_size):
    """stripe = 4 at n = 30: blocks cross stripes; iter_trace_chunks block
    for block against the reference's, nodes or arrays alike."""
    prm = pop.population_delay_arrays(_fl(FLConfig, 30), 16)
    nodes = pop.nodes_for_range(prm, 0, 30)
    ref_nodes = ref_pop.nodes_for_range(prm, 0, 30)
    for src, ref_src in ((prm, prm), (nodes, ref_nodes)):
        got = list(pop.iter_trace_chunks(
            src, CHANNEL_PROFILES["churn"], 4, seed=5,
            block_size=block_size, stripe=4))
        want = list(ref_pop.iter_trace_chunks(
            ref_src, REF_PROFILES["churn"], 4, seed=5,
            block_size=block_size, stripe=4))
        assert [(lo, hi) for lo, hi, _ in got] == \
            [(lo, hi) for lo, hi, _ in want]
        for (_, _, g), (_, _, w) in zip(got, want):
            _traces_equal(g, w)
        _traces_equal(pop.generate_trace_chunked(
            src, CHANNEL_PROFILES["churn"], 4, seed=5,
            block_size=block_size, stripe=4), ref_pop.generate_trace_chunked(
            ref_src, REF_PROFILES["churn"], 4, seed=5,
            block_size=block_size, stripe=4))


def test_chunked_trace_refusals(prm):
    for kw in (dict(block_size=0), dict(block_size=4, stripe=0)):
        with pytest.raises(ValueError):
            next(pop.iter_trace_chunks(prm, CHANNEL_PROFILES["churn"], 2,
                                       seed=0, **kw))


# ----------------------------------------------------------- chunked solver
def _assert_contract(got, want):
    """The allocator contract; t* bit-equal where it came out so here."""
    assert got.t_star == want.t_star
    assert abs(got.t_star - want.t_star) <= 2e-6 * (1.0 + want.t_star)
    np.testing.assert_allclose(got.loads, want.loads, rtol=0.0, atol=1e-4)
    np.testing.assert_allclose(got.returns, want.returns, rtol=0.0,
                               atol=1e-4)
    assert got.u_star == pytest.approx(want.u_star, abs=1e-4)


def test_chunked_solver_matches_reference(prm):
    kw = dict(prm=prm, client_caps=CAP, server=None, u_max=U_MAX, m=M)
    got = pop.two_step_allocate_chunked(**kw, device="cpu")
    want = ref_pop.two_step_allocate_chunked(**kw)
    _assert_contract(got, want)
    assert got.coded_return == want.coded_return == U_MAX


def test_chunked_solver_with_server_node_matches_reference(prm):
    kw = dict(prm=prm, client_caps=CAP, u_max=U_MAX, m=M, **LIGHT)
    got = pop.two_step_allocate_chunked(
        server=NodeDelayParams(mu=50.0, alpha=2.0, tau=1e-4, p=0.05),
        block_size=97, device="cpu", **kw)
    want = ref_pop.two_step_allocate_chunked(
        server=RefNode(mu=50.0, alpha=2.0, tau=1e-4, p=0.05),
        block_size=N + 1, **kw)
    _assert_contract(got, want)
    assert got.coded_return == pytest.approx(want.coded_return, abs=1e-4)


def test_chunked_solver_asymmetric_links_match_reference():
    """Asymmetric links (the per-direction pair grid) from node objects,
    with per-node caps; small erasures keep the grid narrow."""
    base = pop.population_delay_arrays(_fl(FLConfig, 20), 16)
    nodes = [NodeDelayParams(mu=float(base["mu"][j]), alpha=2.0,
                             tau=float(base["tau_down"][j]), p=0.002,
                             tau_up=1.5 * float(base["tau_down"][j]),
                             p_up=0.001) for j in range(20)]
    ref_nodes = [RefNode(**vars(nd)) for nd in nodes]
    caps = np.arange(20) % 4 + 2.0
    kw = dict(client_caps=caps, server=None, u_max=8.0, m=50.0, **LIGHT)
    got = pop.two_step_allocate_chunked(nodes, device="cpu", **kw)
    want = ref_pop.two_step_allocate_chunked(ref_nodes, **kw)
    _assert_contract(got, want)


def test_chunked_solver_refusals(prm):
    kw = dict(prm=prm, server=None, device="cpu")
    for mod_kw, match in ((dict(client_caps=CAP, u_max=1.0,
                                m=10.0 * N * CAP), "infeasible"),
                          (dict(client_caps=CAP, u_max=U_MAX, m=M,
                                block_size=0), "block_size"),
                          (dict(client_caps=np.ones(3), u_max=U_MAX, m=M),
                           "caps shape")):
        with pytest.raises(ValueError, match=match):
            pop.two_step_allocate_chunked(**kw, **mod_kw)
        with pytest.raises(ValueError, match=match):
            ref_pop.two_step_allocate_chunked(prm=prm, server=None,
                                              **mod_kw)


@pytest.fixture(scope="module")
def one_shot(prm):
    return pop.two_step_allocate_chunked(
        prm=prm, client_caps=CAP, server=None, u_max=U_MAX, m=M,
        block_size=N, device="cpu", **LIGHT)


@pytest.mark.parametrize("block_size", [1, pop.SUM_STRIPE - 1, pop.SUM_STRIPE,
                                        pop.SUM_STRIPE + 1, N])
def test_chunked_solver_bit_identical_across_blocks(prm, one_shot,
                                                    block_size):
    alloc = pop.two_step_allocate_chunked(
        prm=prm, client_caps=CAP, server=None, u_max=U_MAX, m=M,
        block_size=block_size, device="cpu", **LIGHT)
    assert alloc.t_star == one_shot.t_star
    np.testing.assert_array_equal(alloc.loads, one_shot.loads)
    np.testing.assert_array_equal(alloc.returns, one_shot.returns)


def test_chunked_solver_fold_is_the_stripe_fold():
    """The total is a left fold down each 128-wide stripe, then over the
    stripe sums: the order of a Python loop, not NumPy's pairwise sum."""
    rng = np.random.default_rng(0)
    rets = rng.random(3 * pop.SUM_STRIPE) * np.logspace(-8, 8,
                                                        3 * pop.SUM_STRIPE)
    want = 0.0
    for s in range(3):
        acc = 0.0
        for v in rets[s * pop.SUM_STRIPE:(s + 1) * pop.SUM_STRIPE]:
            acc += v
        want += acc
    assert pop._stripe_fold(rets) == want
