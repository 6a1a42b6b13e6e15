"""The port's crash points and the ``chaos`` command
(``python -m dpcorr_torch chaos``), on the CPU.

- every registered crash point is reachable in the port: ``fleet.
  pre_lease_commit`` arms through ``chaos.install`` and kills inside
  :class:`~dpcorr_torch.serve.fleet.lease.LeaseManager` — in process
  (raise mode) and as a real process death (exit mode, from
  ``DPCORR_CHAOS``) whose stale claim the next claimant breaks;
- one real case of the step-kill sweep: two ``party`` processes with
  per-user budget directories, y killed at ``gate.post_charge`` and
  restarted, the session bit-equal to the uninterrupted in-process run
  and each role's ε (party and user) spent once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from dpcorr_torch import chaos
from dpcorr_torch.serve.fleet import LeaseManager, lease_table


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _env(**extra):
    from test_torch_cli import _child_env

    env = _child_env()
    env.update(extra)
    return env


def test_every_known_point_is_reachable():
    assert chaos.UNREACHABLE_POINTS == frozenset()
    for point in chaos.KNOWN_POINTS:
        chaos.install(chaos.ChaosPlan(point, mode="raise"))
        assert chaos.active().point == point
        with pytest.raises(chaos.SimulatedCrash):
            chaos.point(point)
        chaos.clear()


def test_fleet_point_matches_jax_registry():
    from dpcorr import chaos as jchaos

    assert chaos.KNOWN_POINTS == jchaos.KNOWN_POINTS
    assert "fleet.pre_lease_commit" in chaos.KNOWN_POINTS
    assert "fleet.pre_lease_commit" not in chaos.MATRIX_POINTS


_VICTIM_SRC = """\
from dpcorr_torch import chaos
from dpcorr_torch.serve.fleet.lease import LeaseManager
chaos.install(chaos.plan_from_env())
m = LeaseManager({lease_dir!r}, "victim", n_shards=2, ttl_s=30.0)
m.acquire(1)
print("survived")
"""


def test_pre_lease_commit_kills_the_process_and_the_claim_is_broken(
        tmp_path):
    """``DPCORR_CHAOS=point=fleet.pre_lease_commit`` kills a real process
    (exit 42) between winning the claim and committing the lease: no
    lease file, one claim file. A rival is refused while the claim is
    fresh, then breaks it and takes the shard at epoch 1."""
    lease_dir = str(tmp_path / "leases")
    proc = subprocess.run(
        [sys.executable, "-c", _VICTIM_SRC.format(lease_dir=lease_dir)],
        capture_output=True, text=True, timeout=120,
        env=_env(DPCORR_CHAOS="point=fleet.pre_lease_commit,mode=exit"))
    assert proc.returncode == chaos.EXIT_CODE, proc.stderr
    assert "survived" not in proc.stdout
    assert lease_table(lease_dir) == {}
    assert sorted(n for n in os.listdir(lease_dir) if ".claim." in n) == [
        "shard-0001.claim.1"]
    with open(os.path.join(lease_dir, "shard-0001.claim.1")) as fh:
        claimed = json.load(fh)
    assert claimed["owner"] == "victim"
    now = [claimed["ts"] + 1.0]
    rival = LeaseManager(lease_dir, "rival", n_shards=2, ttl_s=30.0,
                         clock=lambda: now[0])
    assert not rival.acquire(1)  # the victim's claim is still fresh
    now[0] += 30.0
    assert rival.acquire(1)
    rec = rival.owner_of(1)
    assert (rec["owner"], rec["epoch"]) == ("rival", 1)
    assert not [n for n in os.listdir(lease_dir) if ".claim." in n]


def test_chaos_command_refuses_an_unknown_point():
    from dpcorr_torch.__main__ import main

    with pytest.raises(SystemExit, match="unknown chaos point"):
        main(["chaos", "--device", "cpu", "--points", "fleet.nope"])


def test_chaos_cli_single_case_tcp(tmp_path):
    """One case of the sweep over real TCP: y killed at gate.post_charge
    (exit 42) and restarted with the same command line; the command
    itself asserts bit-identity with the in-process reference, one charge
    per role in the ledger and in the per-user directory, clean
    transcripts and balanced trails."""
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.protocol.messages import read_transcript_meta
    from dpcorr_torch.protocol.party import ProtocolSpec

    work = tmp_path / "chaos"
    proc = subprocess.run(
        [sys.executable, "-m", "dpcorr_torch", "chaos", "--device", "cpu",
         "--points", "gate.post_charge", "--roles", "y", "--n", "400",
         "--timeout", "1", "--case-timeout", "90",
         "--workdir", str(work)],
        capture_output=True, text=True, timeout=240, env=_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["ok"] and doc["device"] == "cpu"
    assert [c["case"] for c in doc["cases"]] == [
        "ni_sign.y.gate.post_charge"]
    case = work / "ni_sign_y_gate_post_charge"
    # the victim's transcript header records the armed plan
    meta = read_transcript_meta(str(case / "transcript.y.jsonl"))
    assert meta["chaos"]["point"] == "gate.post_charge"
    assert meta["chaos"]["mode"] == "exit"
    spec = ProtocolSpec(family="ni_sign", n=400, eps1=1.0, eps2=0.5)
    for role in ("x", "y"):
        bal = read_user_balances(str(case / f"budget-{role}"))
        assert bal[f"user-{role}"]["l"] == sum(
            spec.charges_for(role).values())
