"""The paper's driver on the port (``repro_torch.launch.mnist_codedfedl``)
against ``benchmarks/bench_fed_training.run`` and
``examples/mnist_codedfedl.py``, on the CPU.

Reduced size: m = 600 (30 clients of 20 points), q = 64, d = 32, 40
rounds, the test set of 500 points.  The reference's (Omega, delta) and
coded parity generators are carried over (``repro_torch.carry``), so both
packages train the same model on the same embedded shards.  Held to:

  * every history's simulated wall clock equal, the returned counts
    equal, test accuracies within 2 / m_test (float32 products in another
    order can move a point across an argmax);
  * the rows' simulated-wall, band and speedup fields equal wherever no
    accuracy lies within that tolerance of gamma;
  * ``engine_speedup``'s row name and layout (its timings are host
    seconds);
  * `main`'s printed CSV header and accuracy table as the example's.

The reference's engine comparison (two coded builds at n = 32, l = 64)
runs at a smaller size here (``l = q = 8``, 5 rounds) on both sides:
only its row's layout is compared.
"""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.config import RFFConfig as RefRFFConfig
from repro.core import rff as ref_rff

from repro_torch import carry
from repro_torch.launch import mnist_codedfedl

ROOT = Path(__file__).resolve().parents[1]
SIZE = dict(m_train=600, q=64, d=32, iters=40)
M_TEST = max(500, SIZE["m_train"] // 6)
ACC_TOL = 2.0 / M_TEST
ENGINE = dict(l=8, q=8, c=2, iters=5)
N, SEED, DELTA = 30, 0, 0.2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_bench():
    """``benchmarks.bench_fed_training``, read-only, the repository root on
    sys.path as the example puts it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import bench_fed_training
    return bench_fed_training


def _reference_generators(u: int, l: int):
    import jax

    from repro.core import encoding as ref_enc

    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(SEED + 99), None,
                           length=N)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


@pytest.fixture(scope="module")
def pair():
    """(the port's run_paper dict and printed lines, the reference's rows
    and results)."""
    bft = _reference_bench()
    real_engine = bft.engine_speedup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bft, "engine_speedup", lambda: real_engine(**ENGINE))
        rows, results = bft.run(return_histories=True, **SIZE)
    d, q = SIZE["d"], SIZE["q"]
    omega, delta = ref_rff.rff_params(
        RefRFFConfig(q=q, sigma=2.0 if d < 256 else 5.0), d)
    l = SIZE["m_train"] // N
    gens = carry.generators_from_reference(
        _reference_generators(int(round(DELTA * N * l)), l), device="cpu")
    lines = []
    got = mnist_codedfedl.main(
        device="cpu", out=lines.append, engine_kwargs=ENGINE,
        rff_draw=(np.asarray(omega), np.asarray(delta)),
        parity_generators={"coded": gens}, **SIZE)
    return got, lines, rows, results


def _accs(history):
    return np.array([h.accuracy for h in history])


@pytest.mark.parametrize("scheme", mnist_codedfedl.SCHEMES)
def test_histories_match_reference(pair, scheme):
    got, _, _, results = pair
    g, w = got["results"][scheme].history, results[scheme].history
    assert [h.wall_clock for h in g] == [h.wall_clock for h in w]
    assert [h.returned for h in g] == [h.returned for h in w]
    ga, wa = _accs(g), _accs(w)
    np.testing.assert_array_equal(np.isnan(ga), np.isnan(wa))
    assert np.isnan(ga).sum() == len(ga) - (SIZE["iters"] // 5 + 1)
    keep = ~np.isnan(wa)
    np.testing.assert_allclose(ga[keep], wa[keep], rtol=0, atol=ACC_TOL)
    assert got["results"][scheme].t_star == results[scheme].t_star


def _row(rows, name):
    (row,) = [r for r in rows if r[0] == name]
    return row


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";"))


def test_rows_match_reference(pair):
    got, _, rows, results = pair
    assert [r[0] for r in got["rows"]] == [r[0] for r in rows]
    for scheme in mnist_codedfedl.SCHEMES:
        g = _fields(_row(got["rows"], f"fed_{scheme}_sim")[2])
        w = _fields(_row(rows, f"fed_{scheme}_sim")[2])
        assert g["wall"] == w["wall"]
        assert abs(float(g["acc"]) - float(w["acc"])) <= ACC_TOL + 1e-3
    for scheme in ("naive", "coded"):
        name = f"fed_{scheme}_wall_bands_r8"
        assert _row(got["rows"], name)[2] == _row(rows, name)[2]
    gap = "fed_noniid_acc_gap_naive_minus_greedy"
    assert abs(float(_row(got["rows"], gap)[2])
               - float(_row(rows, gap)[2])) <= 2 * ACC_TOL + 1e-3
    # gamma and the times to it, wherever no accuracy is near gamma: a
    # port accuracy within ACC_TOL of the reference's, and gamma within
    # 0.95 ACC_TOL, cross gamma only from within 2 ACC_TOL of it
    gamma = 0.95 * results["naive"].history[-1].accuracy
    assert abs(got["gamma"] - gamma) <= 0.95 * ACC_TOL
    near = {s: bool(np.any(np.abs(_accs(results[s].history) - gamma)
                           <= 2 * ACC_TOL)) for s in results}
    for s, res in results.items():
        if not near[s]:
            want = next((h.wall_clock for h in res.history
                         if h.accuracy >= gamma), float("inf"))
            assert got["t_gamma"][s] == want, s
    g = _fields(_row(got["rows"], "fed_speedup_vs_naive")[2])
    w = _fields(_row(rows, "fed_speedup_vs_naive")[2])
    if not (near["naive"] or near["coded"]):
        assert g["tU/tC"] == w["tU/tC"]
    if not (near["greedy"] or near["coded"]):
        assert _row(got["rows"], "fed_speedup_vs_greedy")[2] \
            == _row(rows, "fed_speedup_vs_greedy")[2]


def test_engine_speedup_row(pair):
    got, _, rows, _ = pair
    name = "fed_engine_speedup_coded_n32"
    pattern = re.compile(r"legacy_us=\d+;speedup=\d+\.\dx")
    for r in (_row(got["rows"], name), _row(rows, name)):
        assert r[1] > 0 and pattern.fullmatch(r[2]), r
    runs = got["engine"]
    assert set(runs) == {"batched", "legacy"}
    for engine, run in runs.items():
        assert run["experiment"].spec.engine == engine
        assert run["experiment"].n == 32
        assert len(run["result"].history) == ENGINE["iters"]
        assert run["seconds"] > 0
    # both engines see the same rounds (the legacy oracle on the host)
    b, lg = runs["batched"]["result"], runs["legacy"]["result"]
    assert [h.returned for h in b.history] == [h.returned for h in lg.history]
    np.testing.assert_allclose([h.wall_clock for h in b.history],
                               [h.wall_clock for h in lg.history],
                               rtol=1e-6)


def _reference_printed(rows, results, capsys) -> list:
    """What ``examples/mnist_codedfedl.py`` prints for these results."""
    spec = importlib.util.spec_from_file_location(
        "mnist_codedfedl_example", ROOT / "examples" / "mnist_codedfedl.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    bft = _reference_bench()
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bft, "run", lambda **kw: (rows, results))
        mp.setattr(sys, "argv", ["mnist_codedfedl.py"])
        example.main()
    return capsys.readouterr().out.splitlines()


def test_main_prints_the_examples_table(pair, capsys):
    got, lines, rows, results = pair
    want = _reference_printed(rows, results, capsys)
    printed = "\n".join(lines).splitlines()
    assert len(printed) == len(want)
    assert printed[0] == want[0] == "name,us_per_call,derived"
    n_rows = len(rows)
    for g, w in zip(printed[1:1 + n_rows], want[1:1 + n_rows]):
        assert g.split(",")[0] == w.split(",")[0]
    table = re.compile(r"  iter +(\d+)  naive=(\S+) greedy=(\S+) coded=(\S+)")
    for g, w in zip(printed[1 + n_rows:], want[1 + n_rows:]):
        mg, mw = table.fullmatch(g), table.fullmatch(w)
        if mw is None:
            assert g == w
            continue
        assert mg is not None and mg.group(1) == mw.group(1)
        for a, b in zip(mg.groups()[1:], mw.groups()[1:]):
            if b == "nan":
                assert a == "nan"
            else:
                assert abs(float(a) - float(b)) <= ACC_TOL + 1e-3
