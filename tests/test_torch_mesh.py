"""The port's client mesh (``repro_torch.launch.mesh``, the sharded round
of ``repro_torch.core.fed_runtime``) against the reference's unsharded
runs, on the CPU with gloo.

The reference's mesh tests (``tests/test_sharded_engine.py``) shard over
XLA host devices in one process; the port shards over the ranks of a
``torch.distributed`` group, SPMD.  One 8-rank gloo group is spawned for
the module (`repro_torch.launch.mesh.spawn`); its ranks run every case of
``tests/torch_mesh_cases.py`` in turn, each on the first k ranks, and the
reference runs here, unsharded, on one JAX CPU device, with the inputs of
``tests/test_sharded_engine.py``.  The reference's parity generators (and
secure-aggregation masks) go to the ranks, which take them over through
``repro_torch.carry``.
Held to:

  * the wall clock and the returned counts equal (host NumPy, the same on
    every rank); theta within atol 1e-5 and eval losses within rtol 1e-4,
    atol 1e-5 (the reference test's tolerances: the shards' sums reach
    the all-reduce in another order); theta bit-equal across the ranks;
  * a rank past the first k refused, naming its rank;
  * a sharded kill/resume bit-identical to the uninterrupted sharded run;
    a sharded service job's ``events.jsonl`` byte-equal to an unsharded
    job's, with rank 0's root alone written; with one root for every
    rank, a service dropped and the job submitted again resumes bit for
    bit, and a checkpoint write failing on rank 0 fails the block on
    every rank, which retry in step;
  * the legacy engine ignores the mesh, as the reference's does (bit-equal
    to the unsharded legacy run), and a sweep replays ``spec.mesh``;
  * the refusals (adaptive, return faults, fused_embed, hier, a bad axis
    name, too many ranks) raise the reference's types and messages;
  * ``mesh=1`` in a plain process bit-identical to ``mesh=None``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from test_sharded_engine import _data as ref_data
from test_sharded_engine import _sim as ref_sim

from repro import api as ref_api
from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.core import secure_agg as ref_sa
from repro.launch.mesh import make_client_mesh as ref_make_client_mesh

from repro_torch import api as t_api
from repro_torch import config as t_config
from repro_torch.core import fed_runtime as t_runtime
from repro_torch.core import secure_agg as t_sa
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.service import ExperimentService
from repro_torch.obs import spans as t_spans

SEED = 3
# each collective of the group: a rank left waiting on one that failed
# raises after this
COLLECTIVE_TIMEOUT_S = 60.0
# the whole spawn, every case on every rank: ~34 s alone on 8 CPU cores,
# so a few times that leaves room for a loaded host (the other pytest
# workers beside the 8 ranks)
SPAWN_DEADLINE_S = 300.0
BY_ID = {c.id: c for c in cases.CASES}
TRAJECTORY = [c.id for c in cases.CASES if c.kind == "run" and c.eval]
PADDED = [c.id for c in cases.CASES if c.id.startswith("padded-")]
MULTI = [c.id for c in cases.CASES if c.kind == "multi"]
SCHEMES_2 = ["ideal", "unfused", "partial_coded", "drift_churn", "secure"]
REFUSE = [c.id for c in cases.CASES if c.kind == "refuse"]


@functools.lru_cache(maxsize=None)
def _reference_generators(u: int, n: int):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(SEED + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, cases.L))(keys))


def _reference_masks(u: int):
    """The reference's pair masks, one a pair in `secure_agg.pairs` order,
    from its session key PRNGKey(seed + 1234)."""
    key = jax.random.PRNGKey(SEED + 1234)
    like = ref_enc.LocalParity(x=jnp.zeros((u, cases.Q), jnp.float32),
                               y=jnp.zeros((u, cases.C), jnp.float32))
    masks = [ref_sa._mask_like(ref_sa._pair_key(key, i, j), like, 1.0)
             for i, j in t_sa.pairs(cases.N)]
    return (np.stack([np.asarray(m.x) for m in masks]),
            np.stack([np.asarray(m.y) for m in masks]))


def _t_spec(case, **over):
    kw = dict(case.spec_kw, **over)
    return t_config.ExperimentSpec(
        **cases.spec_kwargs(t_config, case.n, case.scheme, **kw))


def _carried(case) -> dict:
    """What the ranks take over from the reference for `case`: the
    parity generators of a coded-family scheme (and the secure masks)."""
    if case.kind in ("refuse", "sweep") or case.scheme not in (
            "coded", "partial_coded"):
        return {}
    xs, ys = cases.data(case.n)
    # the port's host setup is the reference's bit for bit: its u is the
    # reference's
    u = t_api.build_experiment(_t_spec(case), xs, ys, device="cpu").u
    out = {"parity_generators": _reference_generators(u, case.n)}
    if case.spec_kw.get("secure_aggregation"):
        out["secure_masks"] = _reference_masks(u)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on every rank of one 8-rank gloo group: a list, one
    ``{case id: result}`` a rank."""
    carried = {c.id: _carried(c) for c in cases.CASES}
    tmp = str(tmp_path_factory.mktemp("mesh"))
    return t_mesh.spawn(cases.run_cases, cases.WORLD,
                        args=(cases.CASES, carried, tmp),
                        timeout=COLLECTIVE_TIMEOUT_S,
                        deadline=SPAWN_DEADLINE_S)


def _np(theta):
    return (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
            else np.asarray(theta))


def _members(ranks, cid):
    """The results of the k ranks of case `cid`; the others refused,
    naming their rank."""
    k = BY_ID[cid].k
    for r in range(k, cases.WORLD):
        assert f"rank {r} is not one of the {k} ranks" in \
            ranks[r][cid]["refused"]
    return [ranks[r][cid] for r in range(k)]


def _same_across(results, key="theta"):
    for other in results[1:]:
        np.testing.assert_array_equal(other[key], results[0][key])


def _held_to(got, want, losses=False):
    """A rank's run against the reference's: wall clock and returned
    counts equal, theta within 1e-5 (losses within rtol 1e-4, atol
    1e-5)."""
    assert got["wall"] == [h.wall_clock for h in want.history]
    assert got["returned"] == [h.returned for h in want.history]
    np.testing.assert_allclose(got["theta"], _np(want.theta), atol=1e-5)
    if losses:
        np.testing.assert_allclose(got["loss"],
                                   [h.loss for h in want.history],
                                   rtol=1e-4, atol=1e-5)


def test_inputs_are_the_reference_tests():
    for n in (cases.N, 6):
        for got, want in zip(cases.data(n), ref_data(n=n)):
            np.testing.assert_array_equal(got, want)
    xs, ys = ref_data()
    want = ref_sim(xs, ys, "coded").spec.to_dict()
    assert _t_spec(BY_ID["coded-k1"]).to_dict() == want


@pytest.mark.parametrize("cid", TRAJECTORY)
def test_mesh_matches_reference_trajectory(ranks, cid):
    """test_mesh_matches_single_device_trajectory at k ranks: eval every
    round, 20 rounds."""
    case = BY_ID[cid]
    got = _members(ranks, cid)
    _same_across(got)
    xs, ys = ref_data()
    trace = lambda th: (float(np.abs(np.asarray(th)).sum()), 0.0)  # noqa
    want = ref_sim(xs, ys, case.scheme).run(case.rounds, eval_fn=trace,
                                            eval_every=1)
    _held_to(got[0], want, losses=True)


@pytest.mark.parametrize("cid", PADDED)
def test_mesh_pads_indivisible_client_axis(ranks, cid):
    """6 clients (7 fused rows for coded) over 4 ranks: the zero rows add
    nothing."""
    case = BY_ID[cid]
    got = _members(ranks, cid)
    _same_across(got)
    xs, ys = ref_data(n=6)
    _held_to(got[0], ref_sim(xs, ys, case.scheme).run(case.rounds))


@pytest.mark.parametrize("cid", MULTI)
def test_mesh_run_multi_matches_reference(ranks, cid):
    case = BY_ID[cid]
    got = _members(ranks, cid)
    _same_across(got)
    xs, ys = ref_data()
    want = ref_sim(xs, ys, case.scheme, **case.spec_kw).run_multi(
        *cases.MULTI)
    np.testing.assert_array_equal(got[0]["wall"], want.wall_clock)
    np.testing.assert_array_equal(got[0]["returned"], want.returned)
    np.testing.assert_allclose(got[0]["theta"], np.asarray(want.theta),
                               atol=1e-5)


@pytest.mark.parametrize("cid", SCHEMES_2)
def test_mesh_schemes_match_reference(ranks, cid):
    """Ideal, coded unfused (the parity gradient replicated, outside the
    reduction), partial_coded, a drift_churn channel run and secure
    aggregation at 2 ranks."""
    case = BY_ID[cid]
    got = _members(ranks, cid)
    _same_across(got)
    xs, ys = ref_data()
    want = ref_sim(xs, ys, case.scheme, **case.spec_kw).run(case.rounds)
    _held_to(got[0], want)


def test_mesh_kill_resume_is_bit_identical(ranks):
    got = _members(ranks, "resume")
    for res in got:
        for key in ("theta", "wall", "returned", "n_masked"):
            np.testing.assert_array_equal(res["resumed"][key],
                                          res["whole"][key])
    _same_across([res["whole"] for res in got])
    # rank 0 wrote the checkpoints; every rank saw the same directory
    assert got[0]["files"] == got[1]["files"]
    assert got[0]["files"][0] == "ckpt_000005.npz"
    assert len(got[0]["files"]) == cases.ROUNDS // cases.EVERY
    xs, ys = ref_data()
    want = ref_sim(xs, ys, "coded", checkpoint_every=cases.EVERY).run(
        cases.ROUNDS)
    _held_to(got[0]["whole"], want)


def test_mesh_service_job_matches_unsharded_job(ranks, tmp_path):
    """ExperimentService(mesh=2): theta within 1e-5 and the same rounds as
    an unsharded service job, ``events.jsonl`` byte-equal, and nothing
    written under rank 1's root."""
    got = _members(ranks, "service")
    _same_across(got)
    case = BY_ID["service"]
    xs, ys = cases.data()
    t_spans.reset()
    t_spans.enable()
    try:
        svc = ExperimentService(str(tmp_path), device="cpu")
        svc.submit(_t_spec(case), xs, ys, case.rounds, run_id="job",
                   **cases.to_port(_carried(case)))
        want = svc.run_until_complete()["job"]
    finally:
        t_spans.disable()
        t_spans.reset()
    _held_to(got[0], want)
    events = (tmp_path / "job" / "events.jsonl").read_bytes()
    assert got[0]["events"] == events
    assert got[1]["events"] is None and got[1]["files"] == []
    assert got[0]["files"] == sorted(
        str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
        if p.is_file())


def test_mesh_service_resumes_from_a_shared_root(ranks):
    """Every rank's service on one root, dropped after DROP_AFTER steps;
    the job submitted again to a new service resumes on every rank from
    the checkpoint rank 0 wrote, and ends bit-equal to the uninterrupted
    sharded job, its ``events.jsonl`` and files too."""
    got = _members(ranks, "service-resume")
    whole = _members(ranks, "service")
    for res, ref in zip(got, whole):
        assert res["resumed"]
        assert res["resumed_at"] == cases.DROP_AFTER * cases.EVERY
        assert res["errors"] == [] and res["total_retries"] == 0
        for key in ("theta", "wall", "returned", "n_masked"):
            np.testing.assert_array_equal(res[key], ref[key])
    assert got[0]["events"] == whole[0]["events"]
    assert got[0]["files"] == whole[0]["files"]


def test_mesh_service_checkpoint_write_failure_fails_every_rank(ranks):
    """Rank 0's FAIL_AT-th checkpoint write raises: every rank fails that
    block together (rank 0 with the write's error, the others naming
    rank 0's failure), every rank counts one retry, and the job goes on in
    step to the uninterrupted sharded job's theta and rounds; only that
    checkpoint is missing."""
    got = _members(ranks, "service-write-failure")
    whole = _members(ranks, "service")
    assert len(got[0]["errors"]) == 1
    assert got[0]["errors"][0].startswith("OSError: no space left")
    for res in got[1:]:
        assert len(res["errors"]) == 1
        assert "rank 0 of the client mesh failed to write" in \
            res["errors"][0]
    for res, ref in zip(got, whole):
        assert res["total_retries"] == 1 and not res["quarantined"]
        for key in ("theta", "wall", "returned", "n_masked"):
            np.testing.assert_array_equal(res[key], ref[key])
    lost = f"job/ckpt_{cases.FAIL_AT * cases.EVERY:06d}.npz"
    assert lost in whole[0]["files"]
    assert got[0]["files"] == [f for f in whole[0]["files"] if f != lost]


def test_mesh_legacy_engine_ignores_the_mesh(ranks):
    """The reference's legacy run() never reads its mesh: every rank runs
    the whole per-client loop, bit-equal to the unsharded legacy run;
    run_multi takes the sharded batched step."""
    got = _members(ranks, "legacy")
    case = BY_ID["legacy"]
    xs, ys = cases.data()
    exp = t_api.build_experiment(_t_spec(case), xs, ys, device="cpu",
                                 **cases.to_port(_carried(case)))
    want = exp.run(case.rounds)
    for res in got:
        np.testing.assert_array_equal(res["theta"], _np(want.theta))
        assert res["wall"] == [h.wall_clock for h in want.history]
    multi = exp.run_multi(*cases.MULTI)
    _same_across([res["multi"] for res in got])
    np.testing.assert_array_equal(got[0]["multi"]["wall"], multi.wall_clock)
    np.testing.assert_array_equal(got[0]["multi"]["returned"],
                                  multi.returned)
    np.testing.assert_allclose(got[0]["multi"]["theta"], _np(multi.theta),
                               atol=1e-5)


def test_mesh_sweep_replays_the_spec_mesh(ranks):
    """A sweep of a spec with mesh = 2 builds every deployment on the
    mesh, as the reference's run_sweep replays base_spec: each cell
    against the unsharded sweep."""
    got = _members(ranks, "sweep")
    case = BY_ID["sweep"]
    xs, ys = cases.data()
    exp = t_api.build_experiment(_t_spec(case), xs, ys, device="cpu")
    want = exp.sweep(profiles=cases.SWEEP_PROFILES, **cases.SWEEP)
    for scheme, per in want.results.items():
        for p, multi in per.items():
            _same_across([res[scheme][p] for res in got])
            cell = got[0][scheme][p]
            np.testing.assert_array_equal(cell["wall"], multi.wall_clock)
            np.testing.assert_array_equal(cell["returned"], multi.returned)
            np.testing.assert_allclose(cell["theta"], _np(multi.theta),
                                       atol=1e-5)


@pytest.mark.parametrize("cid", REFUSE)
def test_mesh_refusals_match_reference(ranks, cid):
    """The build_experiment(..., mesh=) override of a spec the reference
    refuses with a mesh: the ranks raise the reference's type and message
    (the reference's own build here, on its one device, with mesh=1)."""
    case = BY_ID[cid]
    xs, ys = ref_data()
    spec = ref_config.ExperimentSpec(**cases.spec_kwargs(
        ref_config, case.n, case.scheme, **case.spec_kw))
    with pytest.raises((ValueError, NotImplementedError)) as info:
        ref_api.build_experiment(spec, xs, ys, mesh=1)
    for res in _members(ranks, cid):
        assert res["error"] == info.type.__name__
        assert res["message"] == str(info.value).replace(
            "repro.hier", "repro_torch.hier")


# ------------------------------------------------- in this process alone
@pytest.mark.parametrize("scheme", ["naive", "greedy", "coded"])
def test_mesh_one_in_a_plain_process_is_bit_identical(scheme):
    """mesh=1 with no process group: a one-rank mesh, the reduction the
    identity, the run the unsharded one bit for bit."""
    case = cases.Case("plain", 1, scheme)
    xs, ys = cases.data()
    runs = [t_api.build_experiment(_t_spec(case, **over), xs, ys,
                                   device="cpu").run(10)
            for over in ({}, {"mesh": 1})]
    assert torch.equal(runs[0].theta, runs[1].theta)
    for a, b in zip(runs[0].history, runs[1].history):
        assert (a.wall_clock, a.returned) == (b.wall_clock, b.returned)
    mesh = t_mesh.make_client_mesh(1)
    assert (mesh.size, mesh.rank, mesh.member, mesh.group) == \
        (1, 0, True, None)


def test_make_client_mesh_validates_device_count():
    msgs = []
    for make in (ref_make_client_mesh, t_mesh.make_client_mesh):
        with pytest.raises(ValueError, match="device") as info:
            make(jax.device_count() + 1)
        msgs.append(str(info.value))
    # the same words up to the hint on how to get more devices
    assert msgs[1].split(" (")[0] == msgs[0].split(" (")[0]
    xs, ys = ref_data()
    for api, extra, mod in ((ref_api, {}, ref_config),
                            (t_api, {"device": "cpu"}, t_config)):
        spec = mod.ExperimentSpec(**cases.spec_kwargs(mod, cases.N, "naive"))
        with pytest.raises(ValueError, match="device"):
            api.build_experiment(spec, xs, ys, mesh=2, **extra)


def test_mesh_rejects_bad_axes_like_the_reference():
    xs, ys = ref_data()
    bad_ref = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))
    bad_port = t_mesh.ClientMesh(size=1, axis_names=("model",))
    msgs = []
    for api, mod, bad, extra in (
            (ref_api, ref_config, bad_ref, {}),
            (t_api, t_config, bad_port, {"device": "cpu"})):
        spec = mod.ExperimentSpec(**cases.spec_kwargs(mod, cases.N, "naive"))
        with pytest.raises(ValueError, match="clients") as info:
            api.build_experiment(spec, xs, ys, mesh=bad, **extra)
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]
    # a mesh object of the right axis is taken as it is
    res = t_api.build_experiment(
        t_config.ExperimentSpec(**cases.spec_kwargs(t_config, cases.N,
                                                    "naive")),
        xs, ys, device="cpu", mesh=t_mesh.make_client_mesh(1)).run(3)
    assert torch.isfinite(res.theta).all()


@pytest.mark.parametrize("rows,k,lo,want", [
    (9, 1, 0, (5, 7)),      # unsharded: the parity row last
    (10, 2, 5, (7, 7)),     # parity row 8 inside, padding row 9 last
    (10, 2, 0, (5, 5)),     # clients only
    (9, 3, 6, (5, 7)),      # parity row last of the last shard
])
def test_shard_live_rows(rows, k, lo, want):
    s = -(-rows // k)
    assert t_runtime._shard_live_rows((5, 7), 8, lo, lo + s) == want
    assert t_runtime._shard_live_rows((5, 5), None, lo, lo + s) == (5, 5)


def test_spawn_reports_a_failing_rank_and_ends_the_rest():
    with pytest.raises(RuntimeError, match="(?s)rank 1: .*failed on purpose"
                       ".*rank 0: terminated after another rank failed"):
        t_mesh.spawn(cases.fail_on_rank_one, 2, timeout=30.0)
