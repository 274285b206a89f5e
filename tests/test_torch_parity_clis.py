"""The port's four parity CLIs behind the audit protocol, on the CPU:
``grad.parity``, ``scenario.parity``, ``infomodels.parity`` and
``social.graphgen_cli --selfcheck``, each run through
`obs.audit.run_legacy_cli`.

Contracts, for each CLI at a small ``--n``:

- exit 0 on the port, its report lines printed;
- with ``--obs-dir``: the ``obs run dir:`` line and exactly one ``audit``
  probe event, whose kind and fields equal the event the reference's
  `run_legacy_cli` writes for the same probe name and verdict; ``report
  audit`` passes the run;
- a failing check injected into what the CLI checks gives exit 1 and a
  ``drift`` event equal to the reference's for the same detail, and
  ``report audit`` exits 1 on the run.

The reference's CLIs themselves are not run here: the probes' surfaces are
held to the reference's in tests/test_torch_audit.py.
"""

import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import sbr_tpu.obs  # noqa: E402,F401  (the reference's run log, for its events)
from sbr_tpu.obs import audit as jaudit  # noqa: E402
from sbr_tpu.obs import report as jreport  # noqa: E402
from sbr_tpu_torch.obs import report  # noqa: E402

CPU = "cpu"
# probe name, module, the CLI's arguments at a small size
CLIS = {
    "grad": ("grad.ift_fd", "sbr_tpu_torch.grad.parity", ["--n", "2"]),
    "scenario": ("scenario.composed", "sbr_tpu_torch.scenario.parity", ["--n", "8", "--banks", "2"]),
    "infomodels": ("infomodel.gossip", "sbr_tpu_torch.infomodels.parity", ["--n", "200"]),
    "graphgen": ("graphgen.layout", "sbr_tpu_torch.social.graphgen_cli",
                 ["--selfcheck", "--n", "200"]),
}
# what each CLI prints on a pass
PASS_LINES = {
    "grad": "-> OK",
    "scenario": "multibank sanity ok",
    "infomodels": "population determinism ok",
    "graphgen": "graphgen selfcheck: 0 failure(s)",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's workers share
    the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("SBR_AUDIT", "SBR_OBS", "SBR_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)


def _main(name: str):
    import importlib

    return importlib.import_module(CLIS[name][1]).main


def _audit_events(run_dir) -> list:
    lines = (Path(run_dir) / "events.jsonl").read_text().splitlines()
    return [e for e in map(json.loads, lines) if e.get("kind") == "audit"]


def _view(ev: dict) -> dict:
    """An event without its clocks."""
    return {k: v for k, v in ev.items() if k not in ("mono", "ts", "duration_ms")}


def _reference_event(probe: str, tmp_path):
    """The reference's `run_legacy_cli` event for a passing ``probe``."""
    d = tmp_path / "ref"
    rc = jaudit.run_legacy_cli(probe, lambda: 0, obs_dir=str(d))
    (ev,) = _audit_events(d)
    return rc, ev


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_passes_with_one_audit_event(name, tmp_path, capsys):
    probe, _mod, argv = CLIS[name]
    run_dir = tmp_path / "port"
    assert _main(name)(argv + ["--device", CPU, "--obs-dir", str(run_dir)]) == 0
    out = capsys.readouterr().out
    assert f"obs run dir: {run_dir}" in out and PASS_LINES[name] in out
    (ev,) = _audit_events(run_dir)
    rc, ref = _reference_event(probe, tmp_path)
    assert rc == 0 and _view(ev) == _view(ref)
    assert set(ev) == set(ref)
    for mod in (report, jreport):
        doc, code = mod.audit_doc(run_dir)
        assert code == 0 and doc["probes"][probe]["verdict"] == "pass"


def _break(name: str, monkeypatch) -> None:
    """Inject one failing check into what CLI ``name`` checks."""
    if name == "grad":
        from sbr_tpu_torch.grad import api

        # a flat forward value: every finite difference is 0
        monkeypatch.setattr(api, "xi_value", lambda *a, **k: torch.tensor(1.0))
    elif name == "scenario":
        from sbr_tpu_torch.sweeps import baseline_sweeps

        real = baseline_sweeps.beta_u_grid

        def flipped(*a, **k):
            g = real(*a, **k)
            status = g.status.clone()
            status.view(-1)[0] = 1 - status.view(-1)[0]
            return dataclasses.replace(g, status=status)

        monkeypatch.setattr(baseline_sweeps, "beta_u_grid", flipped)
    elif name == "infomodels":
        from sbr_tpu_torch import infomodels

        real = infomodels.simulate_info

        def shifted(*a, **k):
            r = real(*a, **k)
            return dataclasses.replace(r, informed_frac=r.informed_frac + 1)

        monkeypatch.setattr(infomodels, "simulate_info", shifted)
    else:
        from sbr_tpu_torch.social import graphgen

        real = graphgen.generate_edges

        def rolled(*a, **k):
            src, dst = real(*a, **k)
            return src[::-1].copy(), dst

        monkeypatch.setattr(graphgen, "generate_edges", rolled)


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_failing_check_is_drift(name, tmp_path, monkeypatch, capsys):
    probe, _mod, argv = CLIS[name]
    _break(name, monkeypatch)
    run_dir = tmp_path / "port"
    assert _main(name)(argv + ["--device", CPU, "--obs-dir", str(run_dir)]) == 1
    assert f"audit[{probe}]: DRIFT" in capsys.readouterr().err
    (ev,) = _audit_events(run_dir)
    assert ev["verdict"] == "drift" and ev["tier"] == "legacy"
    # the reference's protocol on the same failure: an AssertionError's
    # message, or the exit of a battery that returns its code
    if ev["detail"].startswith("legacy battery exit "):
        rc = jaudit.run_legacy_cli(probe, lambda: 1, obs_dir=str(tmp_path / "ref"))
    else:
        def fail():
            raise AssertionError(ev["detail"])
        rc = jaudit.run_legacy_cli(probe, fail, obs_dir=str(tmp_path / "ref"))
    (ref,) = _audit_events(tmp_path / "ref")
    assert rc == 1 and _view(ev) == _view(ref)
    for mod in (report, jreport):
        doc, code = mod.audit_doc(run_dir)
        assert code == 1 and doc["drifted_probes"] == [probe]


def test_graphgen_cli_without_selfcheck_is_usage(capsys):
    assert _main("graphgen")(["--device", CPU]) == 2
    assert "--selfcheck" in capsys.readouterr().out


def test_infomodels_lowerings():
    from sbr_tpu_torch.infomodels.parity import lowerings

    assert lowerings(CPU) == ("lax", "interpret")
    assert lowerings(torch.device("cuda", 0)) == ("lax", "pallas")
