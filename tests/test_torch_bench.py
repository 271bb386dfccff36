"""The port's benchmark launchers (``repro_torch.launch.bench``,
``scenarios``, ``kernel_bench``) against the reference's, on the CPU.

The deployment sizes are ``tests/test_bench_artifact.py``'s tiny ones.
Held to:

  * kernel bench: the five timed functions, on the same inputs, equal to
    the reference's plain (``use_pallas=False``) compositions within the
    kernel tests' rtol = atol = 1e-5, for both of the port's backends; the
    section accepted by both packages' ``validate_kernels``;
    ``compare_kernels`` giving the reference's problem list over the cases
    of ``test_kernel_regression_gate``;
  * scenarios: with the reference's parity generators carried over,
    t*, schedules, wall clocks and times to target equal, losses within
    1e-5 relative;
  * run_schemes: the ``profiles`` section equal to the reference's field
    for field, bit for bit (all but ``host_seconds``); the reference's
    validator accepts the port's artifact, and both validators give the
    same problems on every malformed case of ``test_bench_artifact.py``;
  * the service bench, the refusal of a hierarchical base spec, and the
    port's own artifact name.

The reference's ``scale`` section needs ``jax.experimental.enable_x64``,
which this JAX lacks: a module-scoped fixture points the name at
``jax.enable_x64(True)`` for this module only (as
``tests/test_torch_hier.py`` does).  The reference's grid runs with its
optional sections skipped: the profiles do not depend on them.
"""
import functools
import inspect
import json

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.kernels import ops as ref_ops
from repro.launch import bench as ref_bench
from repro.launch import kernel_bench as ref_kb
from repro.launch import scenarios as ref_scen

from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.launch import bench as t_bench
from repro_torch.launch import kernel_bench as t_kb
from repro_torch.launch import scenarios as t_scen

RTOL = ATOL = 1e-5
LOSS_RTOL = 1e-5
# tests/test_bench_artifact.py's sizes
TINY_NS = (64, 128)
TINY = dict(n_clients=4, l=8, q=12, c=2, iters=5, realizations=2,
            profiles={"uniform": dict(rate_decay=1.0, mac_decay=1.0),
                      "paper": dict(rate_decay=0.95, mac_decay=0.8)},
            scenario_kwargs=dict(n_clients=4, l=8, q=8, c=2, iters=12,
                                 adapt_every=4),
            service_kwargs=dict(n_clients=4, l=8, q=8, c=2, iters=8,
                                block=4),
            kernel_kwargs=dict(n_clients=2, l=16, d=8, q=16, c=2, u=8,
                               iters=3),
            scale_kwargs=dict(ns=TINY_NS, l=4, q=6, c=2, rounds=2,
                              cohort=16, sample_fraction=0.5,
                              trace_block=32),
            telemetry_kwargs=dict(n_clients=4, l=8, q=8, c=2, iters=8,
                                  block=4, repeats=1))
TINY_TELEMETRY_RATIO = 50.0
SECTIONS = ("scenario_kwargs", "service_kwargs", "kernel_kwargs",
            "resilience_kwargs", "scale_kwargs", "telemetry_kwargs")
KERNEL_SHAPES = {"tiny": {k: v for k, v in TINY["kernel_kwargs"].items()
                          if k != "iters"},
                 "smoke": t_kb.SCALES["smoke"]}


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
    """One intra-op thread for the port's small float64 solver ops, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _validate(mod, obj):
    return mod.validate_artifact(obj, scale_required_ns=TINY_NS,
                                 telemetry_max_ratio=TINY_TELEMETRY_RATIO)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's whole artifact at the tiny sizes, and its file."""
    result = t_bench.run_schemes(**TINY, device="cpu")
    path = tmp_path_factory.mktemp("bench") / "BENCH_fed_training_torch.json"
    t_bench.write_artifact(result, str(path))
    return result, path


@pytest.fixture(scope="module")
def ref_grid():
    """The reference's grid at the same sizes, optional sections skipped."""
    return ref_bench.run_schemes(**{**TINY, **{k: {"skip": True}
                                               for k in SECTIONS}})


@functools.lru_cache(maxsize=None)
def _reference_generators(seed, n, u, l):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(seed + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


# ------------------------------------------------------------ kernel bench
def _reference_outputs(inputs: dict, phi) -> dict:
    """The reference's plain compositions over NumPy copies of `inputs`."""
    a = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    n, l, d = a["x_raw"].shape
    q = a["omega"].shape[1]
    phi = jnp.asarray(phi.numpy())

    def grad(p):
        return ref_ops.linreg_grad_masked(p, a["theta"], a["y"], a["mask"])

    embed_b = ref_ops.rff_embed_batched(a["x_raw"], a["omega"], a["delta"])
    return {
        "rff_embed": ref_ops.rff_embed(a["x_raw"].reshape(n * l, d),
                                       a["omega"], a["delta"]),
        "linreg_grad_masked": grad(phi),
        "parity_encode_batched": ref_ops.parity_encode_batched(
            a["g"], a["w"], phi),
        "rff_linreg_grad_fused": ref_ops.rff_linreg_grad_masked(
            a["x_raw"], a["omega"], a["delta"], a["theta"], a["y"],
            a["mask"]),
        "two_pass_embed_grad": grad(embed_b.reshape(n, l, q)),
    }


@pytest.mark.parametrize("shape", list(KERNEL_SHAPES))
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", t_kb.KERNEL_NAMES)
def test_kernel_bench_outputs_match_reference(shape, backend, name):
    inputs = t_kb.bench_inputs(**KERNEL_SHAPES[shape], device="cpu")
    n, l, _ = inputs["x_raw"].shape
    # the gradient and parity calls take one embedded tensor in both
    phi = t_kb.kernel_calls(inputs, "xla")["rff_embed"][0](
        inputs["x_raw"].reshape(n * l, -1)).reshape(n, l, -1)
    fn, args = t_kb.kernel_calls(inputs, backend, phi=phi)[name]
    want = np.asarray(_reference_outputs(inputs, phi)[name])
    got = fn(*args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_kernel_bench_inputs_are_the_references_draw():
    """The reference draws the same numbers in the same order."""
    shape = KERNEL_SHAPES["tiny"]
    got = t_kb.bench_inputs(**shape, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    n, l, d, q, c, u = (shape[k] for k in ("n_clients", "l", "d", "q", "c",
                                           "u"))
    want = [rng.normal(size=(n, l, d)), rng.normal(size=(d, q)) / 5.0,
            rng.uniform(0, 2 * np.pi, size=(q,)),
            rng.normal(size=(q, c)) * 0.1, rng.normal(size=(n, l, c)),
            rng.uniform(size=(n, l)) < 0.8, rng.normal(size=(n, u, l)),
            rng.uniform(0.5, 1.0, size=(n, l))]
    for key, arr in zip(("x_raw", "omega", "delta", "theta", "y", "mask",
                         "g", "w"), want):
        np.testing.assert_array_equal(
            got[key].numpy(), np.asarray(jnp.asarray(arr, jnp.float32)))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_kernel_bench_section_validates_in_both(backend):
    kw = TINY["kernel_kwargs"]
    got = t_kb.run_kernel_bench(**kw, kernel_backend=backend, device="cpu")
    want = ref_kb.run_kernel_bench(**kw, kernel_backend="xla")
    assert t_kb.validate_kernels(got) == []
    assert ref_kb.validate_kernels(got) == []
    assert set(want) <= set(got)
    assert got["shapes"] == want["shapes"] and got["iters"] == want["iters"]
    assert got["backend"] == backend and got["device"] == "cpu"
    # on the CPU the wrappers run their plain versions
    assert got["interpret"] is (backend == "pallas")
    assert set(got["entries"]) == set(t_kb.KERNEL_NAMES)


def test_kernel_bench_constants_are_the_references():
    assert t_kb.KERNEL_NAMES == ref_kb.KERNEL_NAMES
    assert t_kb.SCALES == ref_kb.SCALES
    assert t_kb.DEFAULT_THRESHOLD == ref_kb.DEFAULT_THRESHOLD
    with pytest.raises(ValueError, match="unknown kernel_backend"):
        t_kb.run_kernel_bench(kernel_backend="cuda", device="cpu")


def _speedup(fresh, committed):
    fresh["entries"]["rff_embed"]["us_per_call"] /= 100


def _slowdown(fresh, committed):
    fresh["entries"]["rff_embed"]["us_per_call"] = \
        committed["entries"]["rff_embed"]["us_per_call"] * 10


def _ratio(fresh, committed):
    fresh["fused_vs_two_pass_ratio"] *= 10


def _empty(fresh, committed):
    fresh.clear()


def _nan_entry(fresh, committed):
    fresh["entries"]["two_pass_embed_grad"]["us_per_call"] = float("nan")


# (mutation of the fresh section, threshold): test_kernel_regression_gate's
GATE_CASES = {"same": (None, None), "speedup": (_speedup, None),
              "slowdown": (_slowdown, None), "ratio": (_ratio, None),
              "ratio-loose": (_ratio, 100), "bad-threshold": (None, 0.5),
              "malformed": (_empty, None), "nan": (_nan_entry, None)}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_compare_kernels_matches_reference(artifact, case):
    mutate, threshold = GATE_CASES[case]
    committed = artifact[0]["kernels"]
    fresh = json.loads(json.dumps(committed))
    if mutate is not None:
        mutate(fresh, committed)
    kw = {} if threshold is None else {"threshold": threshold}
    got = t_kb.compare_kernels(fresh, committed, **kw)
    assert got == ref_kb.compare_kernels(fresh, committed, **kw)
    assert bool(got) == (case not in ("same", "speedup", "ratio-loose"))


# --------------------------------------------------------------- scenarios
@pytest.fixture(scope="module")
def scenario_pair():
    kw = TINY["scenario_kwargs"]
    want = ref_scen.run_scenarios(**kw)
    m = kw["n_clients"] * kw["l"]
    u = max(1, int(round(0.25 * m)))       # run_scenarios' delta = 0.25
    gens = carry.generators_from_reference(
        _reference_generators(0, kw["n_clients"], u, kw["l"]), device="cpu")
    got = t_scen.run_scenarios(**kw, device="cpu", parity_generators=gens)
    return got, want


@pytest.mark.parametrize("prof", ref_scen.DEFAULT_SCENARIOS)
def test_scenarios_match_reference(scenario_pair, prof):
    got, want = scenario_pair
    g, w = got["cases"][prof], want["cases"][prof]
    for key in ("channel_profile", "adapt_every"):
        assert g[key] == w[key]
    for variant, exact in (("static", ("time_to_target", "final_wall_clock",
                                       "t_star")),
                           ("adaptive", ("time_to_target", "final_wall_clock",
                                         "t_star_first", "t_star_last",
                                         "n_blocks"))):
        for key in exact:
            assert g[variant][key] == w[variant][key], (variant, key)
        np.testing.assert_allclose(g[variant]["final_loss"],
                                   w[variant]["final_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["target_loss"], w["target_loss"],
                               rtol=LOSS_RTOL)
    assert g["adaptive_speedup"] == w["adaptive_speedup"]
    assert t_scen.validate_scenarios(got) == []
    assert ref_scen.validate_scenarios(got) == []


def test_scenarios_config_is_the_references(scenario_pair):
    got, want = scenario_pair
    assert {k: v for k, v in got["config"].items() if k != "device"} \
        == want["config"]
    assert got["config"]["device"] == "cpu"
    assert t_scen.DEFAULT_SCENARIOS == ref_scen.DEFAULT_SCENARIOS
    with pytest.raises(ValueError, match="unknown channel profile"):
        t_scen.run_scenarios(scenarios=("nope",), device="cpu")


# ------------------------------------------------------------- run_schemes
@pytest.mark.parametrize("prof", list(TINY["profiles"]))
def test_profiles_equal_reference(artifact, ref_grid, prof):
    got = artifact[0]["profiles"][prof]
    want = ref_grid["profiles"][prof]
    assert got["knobs"] == want["knobs"]
    for key in ("coded_speedup_vs_naive", "coded_overhead_vs_ideal"):
        assert got[key] == want[key], key
    assert set(got["schemes"]) == set(want["schemes"])
    for scheme, entry in want["schemes"].items():
        g = dict(got["schemes"][scheme])
        assert set(g) == set(entry), scheme
        g.pop("host_seconds")
        assert g == {k: v for k, v in entry.items() if k != "host_seconds"}, \
            scheme


def test_config_equals_reference(artifact, ref_grid):
    got, want = artifact[0]["config"], ref_grid["config"]
    assert got["schemes"] == want["schemes"]
    assert got["coded_schemes"] == want["coded_schemes"]
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"] == "cpu"
    assert t_bench.SCHEMES == ref_bench.SCHEMES
    assert t_bench.CORE_SCHEMES == ref_bench.CORE_SCHEMES
    assert t_bench.SCHEMA_VERSION == ref_bench.SCHEMA_VERSION
    assert t_bench.HETEROGENEITY_PROFILES == ref_bench.HETEROGENEITY_PROFILES
    assert set(artifact[0]) == set(ref_grid) | {
        "scenarios", "service", "kernels", "resilience", "scale",
        "telemetry"}


def test_reference_validator_accepts_port_artifact(artifact):
    result, path = artifact
    for mod in (ref_bench, t_bench):
        assert _validate(mod, result) == []
        assert _validate(mod, str(path)) == []
    # the strict default ladder refuses the toy ladder in both packages
    strict = t_bench.validate_artifact(result)
    assert strict == ref_bench.validate_artifact(result)
    assert any("population rung" in p for p in strict)


# test_bench_artifact.py's malformed cases
MUTATIONS = [
    (lambda d: d.pop("profiles"), "profiles"),
    (lambda d: d.update(schema_version=99), "schema_version"),
    (lambda d: d["profiles"]["uniform"]["schemes"].pop("ideal"), "ideal"),
    (lambda d: d["profiles"]["uniform"]["schemes"]["coded"].update(
        final_wall_clock_mean=float("nan")), "final_wall_clock_mean"),
    (lambda d: d["profiles"]["uniform"].update(
        coded_speedup_vs_naive=-1.0), "coded_speedup_vs_naive"),
    (lambda d: d["config"].pop("schemes"), "config.schemes"),
    (lambda d: d["config"].update(coded_schemes=[]), "coded_schemes"),
    (lambda d: d["profiles"]["paper"]["schemes"]["coded"].pop(
        "privacy_eps_max_bits"), "privacy_eps_max_bits"),
    (lambda d: d["profiles"]["paper"]["schemes"]["partial_coded"].update(
        t_star=None), "t_star"),
    (lambda d: d.pop("scenarios"), "scenarios"),
    (lambda d: d["scenarios"].pop("cases"), "cases"),
    (lambda d: d["scenarios"]["cases"]["degrade_drift"].update(
        adaptive_speedup=-2.0), "adaptive_speedup"),
    (lambda d: d["scenarios"]["cases"]["speedup_drift"]["static"].update(
        time_to_target=float("nan")), "time_to_target"),
    (lambda d: d.pop("service"), "service"),
    (lambda d: d["service"].update(multiplexed_runs=2), "multiplexed_runs"),
    (lambda d: d["service"].update(resumed_bit_identical=False),
     "resumed_bit_identical"),
    (lambda d: d["service"].update(overhead_ratio=-1.0), "overhead_ratio"),
    (lambda d: d["service"].update(oneshot_seconds=float("nan")),
     "oneshot_seconds"),
    (lambda d: d.pop("kernels"), "kernels"),
    (lambda d: d["kernels"]["entries"].pop("rff_linreg_grad_fused"),
     "rff_linreg_grad_fused"),
    (lambda d: d["kernels"]["entries"]["rff_embed"].update(
        us_per_call=float("nan")), "rff_embed"),
    (lambda d: d["kernels"].update(fused_vs_two_pass_ratio=-1.0),
     "fused_vs_two_pass_ratio"),
    (lambda d: d["kernels"].update(backend="cuda"), "backend"),
    (lambda d: d.pop("scale"), "scale"),
    (lambda d: d["scale"].pop("entries"), "entries"),
    (lambda d: d["scale"]["entries"].pop(0), "population rung"),
    (lambda d: d["scale"]["entries"][0].update(
        wall_seconds=float("nan")), "wall_seconds"),
    (lambda d: d["scale"]["entries"][0].update(
        peak_client_tensor_bytes=10 ** 12), "peak client tensor"),
    (lambda d: d["scale"]["entries"][1].update(sample_fraction=1.5),
     "sample_fraction"),
    (lambda d: d["scale"].pop("identity"), "identity"),
    (lambda d: d["scale"]["identity"].update(bit_identical=False),
     "bit_identical"),
    (lambda d: d.pop("telemetry"), "telemetry"),
    (lambda d: d["telemetry"].update(trajectory_bit_identical=False),
     "trajectory_bit_identical"),
    (lambda d: d["telemetry"].update(journal_deterministic=False),
     "journal_deterministic"),
    (lambda d: d["telemetry"].update(overhead_ratio=1e9),
     "overhead_ratio"),
    (lambda d: d["telemetry"].update(enabled_seconds=float("nan")),
     "enabled_seconds"),
    (lambda d: d["telemetry"]["span_totals"].pop("solver/two_step"),
     "solver/two_step"),
]


@pytest.mark.parametrize("mutate,frag", MUTATIONS)
def test_validators_agree_on_malformed(artifact, mutate, frag):
    broken = json.loads(json.dumps(artifact[0]))   # deep copy
    mutate(broken)
    got = _validate(t_bench, broken)
    assert got == _validate(ref_bench, broken)
    assert any(frag in p for p in got)


@pytest.mark.parametrize("case", ["garbage", "missing", "list", "str"])
def test_validators_agree_on_garbage(tmp_path, case):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    obj = {"garbage": str(bad), "missing": str(tmp_path / "missing.json"),
           "list": [1, 2, 3], "str": str(tmp_path)}[case]
    got = t_bench.validate_artifact(obj)
    assert got and got == ref_bench.validate_artifact(obj)


def test_validators_agree_on_a_file(artifact, tmp_path):
    _, path = artifact
    broken = json.loads(path.read_text())
    broken["service"]["resumed_bit_identical"] = False
    bad = tmp_path / "broken.json"
    bad.write_text(json.dumps(broken))
    got = _validate(t_bench, str(bad))
    assert got == _validate(ref_bench, str(bad))
    assert any("resumed_bit_identical" in p for p in got)


# ---------------------------------------------------- service, refusals, io
def test_service_bench(artifact):
    service = artifact[0]["service"]
    assert service["resumed_bit_identical"] is True
    assert service["multiplexed_runs"] == 3
    assert service["iters"] == TINY["service_kwargs"]["iters"]
    assert service["block_rounds"] == TINY["service_kwargs"]["block"]
    for key in ("oneshot_seconds", "blocked_seconds", "overhead_ratio"):
        assert service[key] > 0


def test_hierarchical_base_spec_refused_like_reference():
    messages = []
    for mod, bench_mod, kw in ((ref_config, ref_bench, {}),
                               (t_config, t_bench, {"device": "cpu"})):
        spec = mod.ExperimentSpec(
            fl=mod.FLConfig(n_clients=4, seed=0),
            train=mod.TrainConfig(learning_rate=0.5), scheme="coded",
            hier_shards=2)
        with pytest.raises(ValueError) as exc:
            bench_mod.run_schemes(**TINY, base_spec=spec, **kw)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert "no edge-aggregator path" in messages[1]
    with pytest.raises(ValueError, match="unknown engine"):
        t_bench.run_schemes(engine="scan", device="cpu")


def test_artifact_is_not_the_references(artifact, tmp_path, monkeypatch):
    default = inspect.signature(t_bench.write_artifact).parameters[
        "out_path"].default
    assert default == t_bench.ARTIFACT_NAME == "BENCH_fed_training_torch.json"
    assert default != ref_bench.ARTIFACT_NAME
    monkeypatch.chdir(tmp_path)
    assert t_bench.write_artifact({"a": 1}) == t_bench.ARTIFACT_NAME
    assert not (tmp_path / ref_bench.ARTIFACT_NAME).exists()
    assert json.loads((tmp_path / t_bench.ARTIFACT_NAME).read_text()) \
        == {"a": 1}


def test_cli_validate(artifact, capsys):
    _, path = artifact
    # the CLI holds the strict ladder: the tiny scale section fails it
    assert t_bench.main(["--validate", str(path)]) == 1
    assert "population rung" in capsys.readouterr().err
    assert t_bench.main(["--validate", str(path) + ".nope"]) == 1
