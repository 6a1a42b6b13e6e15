"""The port's N-party federation (``dpcorr_torch.protocol.matrix`` and
``federation``) against ``dpcorr.protocol``, on the CPU at n = 512.

- the plan is the JAX package's: schedules, ``fed_hash``, plan JSON and
  the ε arithmetic (``optimal_eps``, ``naive_eps``, ``party_eps``, charges)
  are equal;
- every matrix cell is bit-equal to the independent two-party run of the
  port, on both transports, chunked, under faults, and after a crash at
  each ``federation.*`` point; ``finish_batch`` exact is bitwise per cell;
- ε is spent at the release-reuse optimum, once across a crash;
- each package's auditor passes the other's federation transcripts, and
  ``scan_federation`` catches a re-noised release;
- the port's matrix agrees with the JAX federation's within the estimator
  tolerances (``tests/test_torch_protocol.py``).
"""

import threading

import numpy as np
import pytest
import torch

import dpcorr.protocol.matrix as jmatrix
import dpcorr.protocol.scan as jscan
from dpcorr.protocol.federation import run_federation_inproc as jax_run
from dpcorr.serve.ledger import release_factor as jax_release_factor
from dpcorr_torch import chaos
from dpcorr_torch.models.estimators import split_reference as sr
from dpcorr_torch.obs.audit import AuditTrail, read_events
from dpcorr_torch.protocol import InProcTransport, ProtocolRefused, run_inproc
from dpcorr_torch.protocol.federation import (
    make_federation_parties,
    run_federation_inproc,
    run_federation_tcp,
)
from dpcorr_torch.protocol.matrix import FederationPlan, _factor
from dpcorr_torch.protocol.messages import read_transcript
from dpcorr_torch.protocol.scan import (
    federation_balance,
    scan_federation,
    scan_transcript,
)
from dpcorr_torch.serve.ledger import PrivacyLedger, release_factor
from dpcorr_torch.utils import rng

FAMILIES = ("ni_sign", "int_sign", "ni_subg", "int_subg")
N = 512
PARTIES = [("p0", ["a", "b"]), ("p1", ["c"]), ("p2", ["d"])]
ATOL, SUBG_RTOL = 1e-5, 2.5e-7


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    chaos.clear()
    yield
    chaos.clear()


def _plan(family="ni_sign", n=N, eps=1.0, module=None, **kw):
    """The 3-party, 4-column case of benchmarks/protocol_load.py
    --matrix: one local cell (p0's a×b), three pair links."""
    cls = FederationPlan if module is None else module.FederationPlan
    return cls(family=family, n=n, eps=eps, parties=PARTIES, **kw)


def _data(plan, rho=0.6):
    k = plan.k
    cov = np.full((k, k), rho)
    np.fill_diagonal(cov, 1.0)
    xy = np.random.default_rng(plan.seed).multivariate_normal(
        np.zeros(k), cov, size=plan.n)
    return {lab: np.asarray(xy[:, i], np.float32)
            for i, (_owner, lab) in enumerate(plan.columns())}


def _merged(results) -> dict:
    cells: dict = {}
    for res in results.values():
        for key, val in res.cells.items():
            if key in cells:
                assert cells[key] == val, f"parties disagree on {key}"
            cells[key] = val
    return cells


def _run(plan, data, **kw):
    return run_federation_inproc(plan, data, device="cpu", **kw)


# ------------------------------------------------------------ plan ----
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("normalise", [True, False])
def test_release_factor_pin(family, normalise):
    assert _factor(family, normalise) == release_factor(family, normalise) \
        == jax_release_factor(family, normalise)


@pytest.mark.parametrize("kw", [
    {}, {"family": "int_subg", "eps": 0.5, "max_cells_per_round": 1},
    {"family": "ni_subg", "normalise": False, "noise_mode": "hardened",
     "seed": 7, "n": 19433}])
def test_plan_equals_jax(kw):
    ours, theirs = _plan(**kw), _plan(module=jmatrix, **kw)
    assert ours.to_public() == theirs.to_public()
    assert ours.fed_hash() == theirs.fed_hash()
    assert ours.fed == theirs.fed and ours.trace_id() == theirs.trace_id()
    assert ours.describe() == theirs.describe()
    assert ours.optimal_eps() == theirs.optimal_eps()
    assert ours.naive_eps() == theirs.naive_eps()
    assert ours.party_eps() == theirs.party_eps()
    assert ours.artifact_venues() == theirs.artifact_venues()
    for name, _labels in PARTIES:
        assert ours.local_charges(name) == theirs.local_charges(name)
        assert ours.party_links(name) == theirs.party_links(name)
    for p, q in ours.links():
        assert ours.link_session(p, q) == theirs.link_session(p, q)
        rounds = ours.link_rounds(p, q)
        assert rounds == theirs.link_rounds(p, q)
        for r in range(len(rounds)):
            assert ours.round_charges(p, q, r) \
                == theirs.round_charges(p, q, r)
    for i, j in ours.cells():
        assert ours.cell_spec(i, j).spec_hash() \
            == theirs.cell_spec(i, j).spec_hash()
    assert FederationPlan.from_public(theirs.to_public()).fed_hash() \
        == theirs.fed_hash()


def test_plan_eps_arithmetic():
    plan = _plan()  # ni_sign normalised: f = 2
    assert plan.optimal_eps() == 12.0 and plan.naive_eps() == 24.0
    assert plan.party_eps() == {"p0": 6.0, "p1": 4.0, "p2": 2.0}
    lc = plan.local_charges("p0")
    assert lc["charges"] == {"p0": 4.0}
    assert lc["charge_id"].endswith(":local")


# ---------------------------------------------------- finish batch ----
@pytest.mark.parametrize("family", FAMILIES)
def test_finish_batch_exact_is_bitwise_per_cell(family):
    plan = _plan(family=family)
    data = _data(plan)

    def root(lab, side):
        return rng.party_root(rng.column_root(rng.master_key(plan.seed),
                                              lab), side, "replay")

    labels = ["a", "b", "c"]
    rels = [sr.party_release(family, root(lab, "x"), "x", data[lab], 1.0,
                             1.0, device="cpu") for lab in labels]
    keys = [root("d", "y")] * 3
    cols = [data["d"]] * 3
    rho, lo, hi = sr.finish_batch(family, keys, rels, cols, 1.0, 1.0,
                                  device="cpu")
    assert rho.shape == (3,)
    for b in range(3):
        one = sr.finish(family, keys[b], rels[b], cols[b], 1.0, 1.0,
                        device="cpu")
        assert (float(rho[b]), float(lo[b]), float(hi[b])) \
            == tuple(float(v) for v in one)
    vec = sr.finish_batch(family, keys, rels, cols, 1.0, 1.0,
                          engine="vector", device="cpu")
    np.testing.assert_allclose(torch.stack(vec).numpy(),
                               torch.stack([rho, lo, hi]).numpy(),
                               atol=1e-6, rtol=0)


def test_finish_batch_validation():
    key = rng.master_key(1)
    rel = {"batch_means": np.zeros(64, np.float32)}
    col = np.zeros(N, np.float32)
    with pytest.raises(ValueError, match="engine"):
        sr.finish_batch("ni_sign", [key], [rel], [col], 1.0, 1.0,
                        engine="nope", device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        sr.finish_batch("ni_sign", [key, key], [rel], [col], 1.0, 1.0,
                        device="cpu")


# ----------------------------------------------------- bit identity ----
@pytest.mark.parametrize("family", FAMILIES)
def test_matrix_bit_equal_to_independent_runs(family):
    """Every cell equals the port's independent two-party session, and
    the matrix agrees with the JAX federation's within tolerance."""
    plan = _plan(family=family)
    data = _data(plan)
    cells = _merged(_run(plan, data))
    assert sorted(cells) == [f"{i},{j}" for i, j in plan.cells()]
    for i, j in plan.cells():
        ref = run_inproc(plan.cell_spec(i, j), data[plan.label(i)],
                         data[plan.label(j)], device="cpu")["x"]
        got = cells[f"{i},{j}"]
        assert (got["rho_hat"], got["ci_low"], got["ci_high"]) \
            == (ref.rho_hat, ref.ci_low, ref.ci_high), (i, j)
    jcells = _merged(jax_run(_plan(family=family, module=jmatrix), data))
    rtol = SUBG_RTOL if family.endswith("subg") else 0.0
    keys = sorted(cells)
    got = np.array([[cells[k][f] for f in ("rho_hat", "ci_low", "ci_high")]
                    for k in keys])
    want = np.array([[jcells[k][f] for f in ("rho_hat", "ci_low",
                                             "ci_high")] for k in keys])
    close = np.isclose(got, want, rtol=rtol, atol=ATOL).all(1)
    # a sign cell may differ only through a centered value at a tie
    assert close.sum() >= len(keys) - 1, (got, want)


def test_matrix_tcp_chunked_and_faulted_same_bits():
    plan = _plan()
    data = _data(plan)
    ref = _merged(_run(plan, data))
    assert _merged(run_federation_tcp(plan, data, device="cpu")) == ref
    assert _merged(_run(_plan(max_cells_per_round=1), data)) == ref
    res = _run(plan, data, fault={"drop": 0.15, "duplicate": 0.15},
               timeout_s=0.2)
    assert _merged(res) == ref
    assert sum(st["total_retries"] for r in res.values()
               for st in r.stats.values()) > 0


# ------------------------------------------------------------- ε ----
def test_eps_spent_at_release_reuse_optimum():
    plan = _plan()
    data = _data(plan)
    ledgers = {name: PrivacyLedger(1e6) for name, _ in PARTIES}
    res = _run(plan, data, ledgers=ledgers)
    for name, want in plan.party_eps().items():
        assert abs(ledgers[name].spent(name) - want) < 1e-9, name
    total = sum(ledgers[name].spent(name) for name, _ in PARTIES)
    assert abs(total - plan.optimal_eps()) < 1e-9 < plan.naive_eps() - total
    attributed = sum(c["eps_new"] for r in res.values() for c in r.costs)
    assert abs(attributed - plan.optimal_eps()) < 1e-9


def test_budget_refusal_before_any_release():
    plan = _plan()
    ledgers = {name: PrivacyLedger(0.5) for name, _ in PARTIES}
    with pytest.raises(ProtocolRefused):
        _run(plan, _data(plan), ledgers=ledgers, timeout_s=0.2,
             max_retries=3, recv_timeout_s=2.0)


# ----------------------------------------------------- crash-resume ----
#: victims in which the point fires: p0 releases on both its links, p1
#: finishes p0-p1, and mid_matrix fires in every party's join loop
_VICTIMS = {"federation.pre_release": "p0",
            "federation.pre_finish": "p1",
            "federation.mid_matrix": "p2"}


@pytest.mark.parametrize("point", sorted(_VICTIMS))
def test_crash_resume_exactly_once(point, tmp_path):
    victim = _VICTIMS[point]
    plan = _plan()
    data = _data(plan)
    ref = _merged(_run(plan, data))

    def ledgers():
        return {name: PrivacyLedger(
            1e6, path=str(tmp_path / f"ledger.{name}.json"))
            for name, _ in PARTIES}

    endpoints = {lk: InProcTransport() for lk in plan.links()}
    # short ack windows keep the resume's retransmits and drain brief
    fast = dict(timeout_s=0.1, max_retries=400, device="cpu")
    parties = make_federation_parties(
        plan, data, ledgers=ledgers(), endpoints=endpoints,
        journal_dir=str(tmp_path), **fast)
    chaos.install(chaos.ChaosPlan(point, hit=1, mode="raise",
                                  thread_name=f"party-{victim}"))
    results, errors = {}, {}

    def drive(name, party):
        try:
            results[name] = party.run()
        except BaseException as e:  # SimulatedCrash is a BaseException
            errors[name] = e

    threads = {name: threading.Thread(target=drive, args=(name, p),
                                      name=f"party-{name}")
               for name, p in parties.items()}
    try:
        for t in threads.values():
            t.start()
        threads[victim].join(timeout=60)
    finally:
        chaos.clear()
    assert isinstance(errors.pop(victim), chaos.SimulatedCrash)
    fresh = make_federation_parties(
        plan, data, ledgers=ledgers(), endpoints=endpoints,
        journal_dir=str(tmp_path), **fast)
    rerun = threading.Thread(target=drive, args=(victim, fresh[victim]),
                             name=f"party-{victim}")
    rerun.start()
    rerun.join(timeout=60)
    for name, t in threads.items():
        if name != victim:
            t.join(timeout=60)
    assert not errors, errors
    assert _merged(results) == ref
    final = ledgers()
    for name, want in plan.party_eps().items():
        assert abs(final[name].spent(name) - want) < 1e-9, name


# ------------------------------------------------------------ scan ----
def _transcript_paths(plan, tmp_path):
    return {name: [str(tmp_path / f"{plan.link_session(p, q)}.{name}.jsonl")
                   for p, q in plan.party_links(name)]
            for name, _ in PARTIES}


def test_scan_federation_clean_and_balanced_in_both_packages(tmp_path):
    plan = _plan()
    data = _data(plan)
    audits = {name: AuditTrail(str(tmp_path / f"audit.{name}.jsonl"))
              for name, _ in PARTIES}
    _run(plan, data, transcript_dir=str(tmp_path),
         ledgers={name: PrivacyLedger(1e6, audit=audits[name])
                  for name, _ in PARTIES})
    paths = _transcript_paths(plan, tmp_path)
    flat = sorted({t for ts in paths.values() for t in ts})
    assert len(flat) == 2 * len(plan.links())
    for scan, cross, balance in (
            (scan_transcript, scan_federation, federation_balance),
            (jscan.scan_transcript, jscan.scan_federation,
             jscan.federation_balance)):
        for t in flat:
            rep = scan(t)
            assert rep["ok"] and rep["federation"] is True, rep
        rep = cross(flat)
        assert rep["ok"] and rep["labels"] == ["a", "b", "c"], rep
        for name, _ in PARTIES:
            bal = balance(paths[name],
                          read_events(str(tmp_path / f"audit.{name}.jsonl")),
                          expected_local_eps=sum(
                              plan.local_charges(name)["charges"].values()))
            assert bal["ok"], (name, bal)
            assert abs(bal["spent"][name] - plan.party_eps()[name]) < 1e-9


def test_scan_federation_catches_renoised_release(tmp_path):
    plan = _plan()
    _run(plan, _data(plan), transcript_dir=str(tmp_path))
    flat = sorted({t for ts in _transcript_paths(plan, tmp_path).values()
                   for t in ts})
    tampered = [read_transcript(t) for t in flat]
    hits = 0
    for e in tampered[0]:
        w = e.get("wire", {})
        if w.get("msg_type") == "release":
            arts = w["payload"]["artifacts"]
            arts["a"], arts["b"] = arts["b"], arts["a"]
            hits += 1
    assert hits
    for cross in (scan_federation, jscan.scan_federation):
        rep = cross(tampered)
        assert not rep["ok"]
        assert "cross-pair-release-divergence" in {
            v["rule"] for v in rep["violations"]}
        assert plan.link_session("p0", "p1") in " ".join(
            v["detail"] for v in rep["violations"])


# ---------------------------------------------------------- report ----
def test_correlation_matrix_frame_matches_jax():
    pytest.importorskip("pandas")
    from dpcorr.report import correlation_matrix_frame as jframe
    from dpcorr_torch.report import correlation_matrix_frame

    plan = _plan()
    res = _run(plan, _data(plan))
    got = correlation_matrix_frame(res, plan)
    want = jframe(res, plan)
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert list(got[col]) == list(want[col]), col
    assert got["venue"][0] == "local@p0"
    assert len(correlation_matrix_frame(res["p2"])["i"]) \
        == len(res["p2"].cells)
    bad = dict(res["p0"].cells)
    bad["0,1"] = {"rho_hat": 0.0, "ci_low": 0.0, "ci_high": 0.0}
    with pytest.raises(ValueError, match="disagree"):
        correlation_matrix_frame({"p0": res["p0"],
                                  "bad": type(res["p0"])(
                                      party="bad", fed=plan.fed,
                                      cells=bad, eps={})})
