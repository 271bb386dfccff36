"""The port of ``examples/mesh_sweep.py`` (``repro_torch.launch.mesh_sweep``)
against the reference script, at one rank on the CPU.

The reference script runs here as it is, on one JAX CPU device (its mesh
has one device); the port's `main` runs in this process with no process
group (a one-rank mesh), with the reference's coded generators carried
over (``repro_torch.carry``).  Held to: the printed ``[mesh]`` lines equal
(t* and the wall clock are host NumPy, bit-identical), every sweep band
(mean and std of the final wall clock, each scheme and profile) within
rtol 1e-6 of the reference's, the returned counts equal, and the modules
of the mesh importing neither JAX nor the reference.
"""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from repro.core import encoding as ref_enc

from repro_torch import carry
from repro_torch.launch import mesh_sweep

ROOT = Path(__file__).resolve().parents[1]


def _reference_generators(u: int) -> np.ndarray:
    """The reference's per-client generators of the example's coded
    deployment: the split chain from PRNGKey(seed + 99), seed 0."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(99), None,
                           length=mesh_sweep.N)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, mesh_sweep.L))(keys))


def test_mesh_sweep_matches_reference_example(capsys):
    ref = runpy.run_path(str(ROOT / "examples" / "mesh_sweep.py"))
    want = capsys.readouterr().out.splitlines()
    # the coded scheme's u = round(delta * m)
    u = max(1, int(round(0.2 * mesh_sweep.N * mesh_sweep.L)))
    gens = carry.generators_from_reference(_reference_generators(u),
                                           device="cpu")
    lines = []
    got = mesh_sweep.main(device="cpu", parity_generators=gens,
                          out=lines.append)
    mesh_lines = [ln for ln in lines if ln.startswith("[mesh]")]
    assert mesh_lines == [ln for ln in want if ln.startswith("[mesh]")]
    assert len(mesh_lines) == 2
    np.testing.assert_allclose(got["mesh"]["theta"],
                               np.asarray(ref["res"].theta), atol=1e-5)
    # the sweep's bands, scheme by scheme and profile by profile
    band = re.compile(r"^\s+(\w+): +([\d.]+) ± +([\d.]+) simulated s$")
    assert [band.match(ln).groups()[0] for ln in lines if band.match(ln)] \
        == [band.match(ln).groups()[0] for ln in want if band.match(ln)]
    sw_ref, sw = ref["sw"], got["sweep"]
    assert list(sw.results) == list(sw_ref.results)
    for scheme, per in sw_ref.results.items():
        assert list(sw.results[scheme]) == list(per)
        for p, multi in per.items():
            mine = sw.results[scheme][p]
            for a, b in zip(mine.wall_clock_bands(),
                            multi.wall_clock_bands()):
                np.testing.assert_allclose(a, b, rtol=1e-6)
            np.testing.assert_array_equal(mine.returned, multi.returned)


def test_mesh_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.mesh, repro_torch.launch.mesh_sweep\n"
        "import repro_torch.launch.service, repro_torch.api\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
