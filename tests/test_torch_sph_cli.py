"""The port's scenario CLI (``python -m repro_torch.sph``) against the JAX
package's (``python -m repro.sph``), each called in-process through its
``main(argv)``; the port's on ``--device cpu``.

  * ``list --names`` prints the same case names;
  * ``run --json`` (``--backend xla --records fp32``) prints a document
    with the same schema and keys, the same step counts, and
    observables within the fp32-records tolerances of
    ``tests/guard_parity.py`` (velocity nsteps·dt·1e-4, density 1e-6):
    vmax within the velocity bound, rho_err within the density bound
    (over rho0 = 1), ekin within M·vmax·dv + M·dv²/2 (M the fluid mass);
  * ``run --inject`` of a fault the guard cannot cure exits 1 with the
    same ``diverged`` step, checks and event actions;
  * ``sweep`` prints the same member table and summary;
  * ``request`` against a port server streams its frames and exits 0;
  * ``run`` and ``serve`` raise where CUDA is asked for and missing.
"""
import json

import numpy as np
import pytest
import torch

from repro.sph.__main__ import main as jmain
from repro_torch.core.api import Simulation
from repro_torch.core.cases import resolve_ds
from repro_torch.core import recovery
from repro_torch.sph.__main__ import main as tmain
from repro_torch.sph.serve import SimServer
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def _out(capsys, main, argv) -> tuple[int, str]:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_list_names_as_jax(capsys):
    rc, out = _out(capsys, tmain, ["list", "--names"])
    jrc, jout = _out(capsys, jmain, ["list", "--names"])
    assert rc == jrc == 0
    assert out == jout
    assert out.split() == ["cavity", "dam_break", "poiseuille", "taylor_green"]
    _, table = _out(capsys, tmain, ["list"])
    _, jtable = _out(capsys, jmain, ["list"])
    assert table == jtable


RUN = ["run", "taylor_green", "--n", "100", "--nsteps", "24", "--observe-every", "8",
       "--backend", "xla", "--records", "fp32", "--json"]


def test_run_json_as_jax(capsys):
    rc, out = _out(capsys, tmain, RUN + ["--device", "cpu"])
    jrc, jout = _out(capsys, jmain, RUN)
    doc, jdoc = json.loads(out), json.loads(jout)
    assert rc == jrc == 0
    assert list(doc) == list(jdoc)
    assert doc["schema"] == "repro.sph.run/1" and doc["status"] == jdoc["status"] == "ok"
    for k in ("case", "n", "ds", "dt", "backend", "records", "nsteps", "observe_every",
              "guard", "inject", "exit", "stats", "steps_per_sec"):
        assert doc[k] == jdoc[k], k
    assert list(doc["validation"]) == list(jdoc["validation"])
    sim = Simulation.from_case("taylor_green", device="cpu", ds=resolve_ds("taylor_green", 100))
    mass = float(sim.state.fluid.m[~sim.state.fixed].sum())
    dv = 24 * doc["dt"] * 1e-4
    obs, jobs = doc["observables"], jdoc["observables"]
    np.testing.assert_allclose(obs["t"], jobs["t"], rtol=1e-6)
    np.testing.assert_allclose(obs["vmax"], jobs["vmax"], atol=dv)
    np.testing.assert_allclose(obs["rho_err"], jobs["rho_err"], atol=1e-6)
    vmax = max(obs["vmax"])
    np.testing.assert_allclose(obs["ekin"], jobs["ekin"],
                               atol=mass * vmax * dv + 0.5 * mass * dv * dv)


def test_run_backend_pallas_is_kernel(capsys):
    rc, out = _out(capsys, tmain, ["run", "taylor_green", "--n", "100", "--nsteps", "8",
                                   "--backend", "pallas", "--json", "--device", "cpu"])
    doc = json.loads(out)
    assert rc == 0 and doc["backend"] == "kernel" and doc["status"] == "ok"


@pytest.mark.parametrize("inject", ["teleport", "dt"])
def test_run_guard_divergence_exit_1_as_jax(capsys, inject):
    argv = ["run", "taylor_green", "--n", "200", "--nsteps", "40", "--guard",
            "--inject", inject, "--guard-block", "8", "--json"]
    rc, out = _out(capsys, tmain, argv + ["--device", "cpu"])
    jrc, jout = _out(capsys, jmain, argv)
    doc, jdoc = json.loads(out), json.loads(jout)
    assert rc == jrc == 1
    assert doc["status"] == jdoc["status"] == "diverged"
    d, jd = doc["diverged"], jdoc["diverged"]
    assert list(d) == list(jd)
    assert (d["step"], d["checks"], d["word"]) == (jd["step"], jd["checks"], jd["word"])
    assert [e["action"] for e in d["events"]] == [e["action"] for e in jd["events"]]


def _sweep_rows(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if not ln.startswith("# sweep ")]


def test_sweep_as_jax(capsys):
    argv = ["sweep", "taylor_green", "--batch", "3", "--nsteps", "16", "--block", "8",
            "--n", "100", "--backend", "xla", "--inject", "nan", "--inject-member", "1"]
    rc, out = _out(capsys, tmain, argv + ["--device", "cpu"])
    jrc, jout = _out(capsys, jmain, argv)
    assert rc == jrc == 0
    assert _sweep_rows(out) == _sweep_rows(jout)
    assert "# sweep summary: healthy=2 recovered=1" in out


def test_request_against_port_server(capsys):
    srv = SimServer(slots=2, queue=4, policy=recovery.GuardPolicy(block=8, snapshot_every=1),
                    device="cpu").start()
    try:
        rc, out = _out(capsys, tmain, ["request", "taylor_green", "--port", str(srv.port),
                                       "--n", "100", "--nsteps", "16", "--observe"])
    finally:
        srv.request_drain()
        srv.join(60)
    frames = [json.loads(ln) for ln in out.splitlines()]
    assert rc == 0
    assert [f["type"] for f in frames] == ["accepted", "obs", "done"]
    assert frames[-1]["steps"] == 16


def test_cli_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["run", "taylor_green", "--n", "100", "--nsteps", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["serve", "--single-process", "--port", "0"])
