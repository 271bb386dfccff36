"""The CodedFedL deployment as the benchmark drives it: the port's
``build_experiment`` on the inputs ``gen.make_inputs`` makes from the
seed, and its check against ``reference/codedfedl.py``.

A block is ``run_block(state, K)``: K rounds of every realization, from
the call until its state is on the host.  The runs go ``init_state(rounds,
n_realizations=R)`` -> ``run_block`` until the run is done -> ``finish``,
then the next run from theta = 0 on the same deployment, its delay stream
going on.  A block's units of work are its realization-rounds.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench import gen
from portbench.reference import codedfedl as ref

#: the records of the program's hand-written kernels (its entries of
#: ``work/kernels.json``)
KERNELS = ("linreg_grad_masked", "rff_linreg_grad_masked")


def build_program(cfg: dict, traffic: dict, inp, dev: torch.device):
    """The deployment through the program's entry, on the inputs made."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.config import FLConfig, RFFConfig, TrainConfig
    from repro_torch.core import rff

    n, l, d = inp.x.shape
    fl = FLConfig(n_clients=n, delta=cfg["delta"], psi=cfg["psi"],
                  **cfg["network"])
    train = TrainConfig(learning_rate=inp.lr, l2_reg=cfg["l2_reg"],
                        lr_decay=cfg["lr_decay"],
                        lr_decay_epochs=tuple(cfg["lr_decay_rounds"]))
    spec = ExperimentSpec(fl=fl, train=train,
                          rff=RFFConfig(q=cfg["q"], sigma=cfg["sigma"]),
                          scheme=traffic["scheme"],
                          fused_embed=cfg["fused_embed"])
    kw = {}
    if cfg["fused_embed"]:
        xs = inp.x
        kw["rff_draw"] = (inp.omega, inp.delta)
    else:
        # the embedded deployment's clients hold phi(X): kernel 1
        xs = rff.rff_transform(inp.x.reshape(n * l, d), inp.omega,
                               inp.delta).reshape(n, l, cfg["q"])
    if inp.gens is not None:
        kw["parity_generators"] = inp.gens
    return build_experiment(spec, xs, inp.y,
                            rng=np.random.default_rng(inp.host_seed),
                            device=dev, **kw)


class Runs:
    """The runs the window drives on one deployment, and what each left:
    its blocks, its returned counts and wall clock, its skipped rounds,
    and theta after each block where the run is one of the checked."""

    def __init__(self, exp, rounds: int, R: int, K: int, seed: int,
                 checked: int):
        self.exp, self.rounds, self.R, self.K = exp, rounds, R, K
        self.pick = np.random.default_rng((int(seed), 7))
        self.checked = checked
        self.runs = []
        self.state = None
        self._start()

    def _start(self) -> None:
        i = len(self.runs)
        # run 0 always, then a reservoir of the later runs drawn from the
        # seed, so the runs checked are a sample of all the window's
        keep = i == 0
        if i > 0 and self.checked > 1:
            kept = [r for r in self.runs[1:] if r["thetas"] is not None]
            if len(kept) < self.checked - 1:
                keep = True
            elif self.pick.random() < (self.checked - 1) / i:
                kept[int(self.pick.integers(len(kept)))]["thetas"] = None
                keep = True
        self.runs.append({"blocks": 0, "thetas": [] if keep else None,
                          "n_ret": None, "wall": None, "skipped": None})
        self.state = self.exp.init_state(self.rounds, n_realizations=self.R)

    def turn(self) -> None:
        """Where the run is done, finish it and start the next one."""
        if self.state.done:
            res = self.exp.finish(self.state)
            self.runs[-1]["wall"] = np.asarray(res.wall_clock)
            self._start()

    def block(self) -> int:
        """Run one block of the current run; returns the realization-rounds
        it did."""
        before = self.state.rounds_done
        with torch.profiler.record_function("portbench/run_block"):
            self.state = self.exp.run_block(self.state, self.K)
        run = self.runs[-1]
        run["blocks"] += 1
        run["n_ret"] = np.asarray(self.state.n_ret)
        run["skipped"] = np.asarray(self.state.skipped)
        if run["thetas"] is not None:
            run["thetas"].append(self.state.theta)
        return (self.state.rounds_done - before) * self.R


# ---------------------------------------------------------------- the check
def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    den = float(torch.linalg.vector_norm(b))
    gap = float(torch.linalg.vector_norm(a.float() - b))
    return gap / den if den > 0 else (0.0 if gap == 0 else math.inf)


def check(dep, program: dict, runs: list) -> tuple[dict, list]:
    """The numbers compared: the program's results against the reference
    deployment `dep`, which replays the same delay stream run by run.
    Returns ({name: value}, the (R, rounds) counted rows of each run)."""
    out = {"theta_gap": 0.0, "returned_diff": 0, "wall_gap": 0.0}
    rows = []
    if dep.scheme == "coded":
        out["t_star_gap"] = abs(program["t_star"] - dep.t_star) / dep.t_star
        out["loads_diff"] = int(np.max(np.abs(
            np.asarray(program["loads"]) - dep.loads)))
        out["parity_gap"] = max(_rel(program["parity_x"], dep.parity_x),
                                _rel(program["parity_y"], dep.parity_y))
    for run in runs:
        blocks = [dep.block_delays(min(dep.K, dep.rounds - k * dep.K))
                  for k in range(run["blocks"])]
        rows.append(dep.counted_rows(blocks))
        n_ret = dep.returned(blocks)
        out["returned_diff"] += int(np.sum(n_ret != run["n_ret"]))
        if run["wall"] is not None:
            wall = dep.wall_clock(blocks)
            out["wall_gap"] = max(out["wall_gap"], float(np.max(
                np.abs(run["wall"] - wall) / wall)))
        if run["thetas"]:
            for got, want in zip(run["thetas"], dep.trajectory(blocks)):
                for r in range(dep.R):
                    out["theta_gap"] = max(out["theta_gap"],
                                           _rel(got[r], want[r]))
    return out, rows


# ---------------------------------------------------------------- the entry
class CodedFedL:
    """One deployment built from the seed, driven block by block, then
    checked (``harness.Program``)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 dev: torch.device, *, traced: bool, checked: int):
        from repro_torch.kernels import ops
        from repro_torch.obs import spans

        self.cfg, self.traffic, self.dev = cfg, traffic, dev
        self.K = int(traffic["block_rounds"])
        self.ops = ops
        spec = json.loads((Path(__file__).resolve().parents[1] / "work"
                           / "kernels.json").read_text())
        self.kernels = {k: spec[k] for k in KERNELS}
        self.inp = gen.make_inputs(cfg, traffic, seed, dev)
        if traced:
            spans.enable()
            spans.reset()
        self.exp = build_program(cfg, traffic, self.inp, dev)
        self.setup_spans = {k: v["total_s"]
                            for k, v in spans.totals().items()}
        spans.disable()
        self.runs = Runs(self.exp, int(cfg["rounds"]),
                         int(traffic["realizations"]), self.K, seed, checked)
        self.rows = self.u = None

    def turn(self) -> None:
        self.runs.turn()

    def block(self) -> int:
        return self.runs.block()

    def launches(self) -> dict:
        return dict(self.ops.LAUNCHES)

    def check(self, log) -> tuple[dict, int]:
        exp, runs = self.exp, self.runs.runs
        program = {"t_star": exp.t_star, "loads": np.array(exp.loads),
                   "parity_x": None, "parity_y": None}
        if exp.parity is not None:
            program["parity_x"], program["parity_y"] = (exp.parity.x,
                                                        exp.parity.y)
        skipped = sum(int(np.sum(r["skipped"])) for r in runs)
        del exp, self.exp, self.runs
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        dep = ref.Deployment(self.cfg, self.traffic, self.inp)
        numbers, self.rows = check(dep, program, runs)
        self.u = dep.u
        log(f"check: the reference took {time.perf_counter() - t_ref:.3f} s "
            f"over {len(runs)} runs, theta of "
            f"{sum(1 for r in runs if r['thetas'])}")
        return numbers, skipped

    def fields(self, window: tuple, stretch) -> dict:
        # the counted rows of each realization-round: the window's blocks,
        # then the stretch's, in run order
        flat = []
        for run_rows in self.rows:
            for b in range(0, run_rows.shape[1], self.K):
                flat.append(run_rows[:, b:b + self.K])
        first, n = window
        stretch_rows = []
        if stretch is not None:
            first_s = stretch["first_block"]
            stretch_rows = flat[first_s:first_s + stretch["blocks"]]
        return {"spans": self.setup_spans,
                "window_rows": flat[first:first + n],
                "stretch_rows": stretch_rows, "u": self.u}


#: ``build(cfg, traffic, seed, dev, *, traced, checked)``
build = CodedFedL


def control(cfg: dict, traffic: dict, seed: int, dev: torch.device, *,
            checked: int) -> dict:
    """The numbers of the reference in TF32 put in the program's place:
    its first `checked` runs of the same delay stream, held against the
    float32 reference as a run's are."""
    inp = gen.make_inputs(cfg, traffic, seed, dev)
    ctl = ref.Deployment(cfg, traffic, inp, control=True)
    runs = []
    for _ in range(checked):
        blocks = ctl.run_blocks()
        runs.append({"blocks": len(blocks), "thetas": ctl.trajectory(blocks),
                     "n_ret": ctl.returned(blocks),
                     "wall": ctl.wall_clock(blocks)})
    program = {"t_star": ctl.t_star, "loads": ctl.loads,
               "parity_x": ctl.parity_x, "parity_y": ctl.parity_y}
    numbers, _ = check(ref.Deployment(cfg, traffic, inp), program, runs)
    return numbers
