"""The port's chaos drill (paddle_tpu_torch/tools/chaos_drill.py), the
loadgen CLI's mesh flags and the autoscale report, on the CPU.

The drill arms every registered fault site (the reference's 31) and
drives the subsystem that owns it: every site must come out recovered or
degraded, with its fault_injected_total moved and a readable flight dump,
compile.shard_prop among them. loadgen's --replicas,
--disaggregate, --processes and --slow-replica drive the serving mesh
and report its mesh section, whose autoscale verdict the report tool
reads and replays."""

import json

import pytest

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.profiler.phases import get_phase_accountant
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.tools import autoscale_report, chaos_drill
from paddle_tpu_torch.tools import loadgen as cli
from torch_mesh_parity import no_new_series  # noqa: F401
from torch_one_thread import one_torch_thread  # noqa: F401

COMPILE_SITES = sorted(s for s in faults.FAULT_SITES
                       if s.startswith("compile."))


@pytest.fixture
def plane_off():
    """The drill and loadgen turn the observability layer and the phase
    accountant on; leave both off and empty."""
    yield
    acct = get_phase_accountant()
    acct.disable()
    acct.reset()
    obs.disable()
    obs.get_registry().reset()


def test_drill_recovers_or_degrades_every_site_it_fires(plane_off):
    obs.get_registry().reset()
    rows, problems = chaos_drill.run(device="cpu")
    assert problems == []
    outcome = {site: out for site, out, _note in rows}
    assert sorted(outcome) == sorted(faults.FAULT_SITES)
    drilled = sorted(s for s, o in outcome.items() if o != "-")
    assert len(drilled) == 31 and len(faults.FAULT_SITES) == 31
    assert {outcome[s] for s in drilled} == {"recovered", "degraded"}
    assert chaos_drill.NOT_DRILLED == ()
    assert sorted(s for s in drilled if s.startswith("compile.")) == \
        COMPILE_SITES
    assert outcome["compile.shard_prop"] == "degraded"
    mesh = [s for s in drilled if s.startswith("mesh.")]
    assert len(mesh) == 7
    fam = obs.get_registry().get("fault_injected_total")
    for site in drilled:
        assert fam.labels(site=site).value > 0, site


def test_drill_fails_on_an_undrilled_site(monkeypatch, capsys, plane_off):
    monkeypatch.delitem(chaos_drill.SCENARIOS, "store.get")
    rc = chaos_drill.main(["--device", "cpu", "--site", "store.set"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "no drill scenario: ['store.get']" in err
    assert chaos_drill.main(["--device", "cpu", "--site",
                             "compile.no_such_site"]) == 2


def test_loadgen_disaggregated_mesh_and_autoscale_report(
        tmp_path, capsys, plane_off):
    out = tmp_path / "report.json"
    rc = cli.main(["--device", "cpu", "--scenario", "chat", "--duration",
                   "1.0", "--replicas", "2", "--disaggregate", "--check",
                   "--out", str(out)])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "CHECK PASS" in err and "autoscale" in err
    report = json.loads(out.read_text())
    mesh = report["mesh"]
    assert mesh["disaggregate"] is True
    assert ({r["role"] for r in mesh["replicas"].values()}
            == {"prefill", "decode"})
    assert mesh["handoffs"]["ok"] == report["issued"] > 0
    assert mesh["open"] == 0
    assert autoscale_report.main([str(out), "--check"]) == 0
    assert "CHECK PASS" in capsys.readouterr().err
    assert autoscale_report.main([str(out), "--replay", "--json"]) == 0
    replayed = json.loads(capsys.readouterr().out)
    assert replayed["format"] == 1
    assert replayed["current_replicas"] == 2


def test_loadgen_slow_replica_process_mesh(capsys, plane_off):
    """--slow-replica wedges one worker of a two-process loopback mesh:
    the health detector demotes it SLOW, it stays alive, and every
    request finishes (the run's TTFT burn, --check's last bound, is a
    wall-clock figure this test leaves to the CLI)."""
    rc = cli.main(["--device", "cpu", "--scenario", "chat", "--duration",
                   "1.5", "--slow-replica"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    health = next(line for line in captured.err.splitlines()
                  if line.startswith("# mesh health:"))
    demotions = float(health.split("slow_demotions=")[1].split()[0])
    assert demotions >= 1
    report = json.loads(captured.out)
    mesh = report["mesh"]
    assert all(r["alive"] for r in mesh["replicas"].values())
    assert mesh["open"] == 0
    assert sum(report["finished"].values()) == report["issued"]
