"""The port's two-party protocol (``dpcorr_torch.protocol``) against
``dpcorr.protocol``, on the CPU at n ≤ 2000.

- bits where they must match: the port's session (replay key layout) is
  bit-equal to the port's ``serving_entry`` on the same master key, in
  process, over TCP, under faults and duplicate delivery; the party and
  column key roots, release and wire schemas, spec hashes, canonical bytes
  and array envelopes are bit-equal to the JAX package's;
- tolerance where floats differ: the port's ``split_estimate`` against
  JAX's within 1e-5 absolute (subG also 2.5e-7 relative), a sign-family
  row beyond that only where a privately centered value lies within 1e-5
  of 0 (``tests/test_torch_serve.py``'s rule);
- files both ways: transcripts scan clean under either package's auditor,
  ledgers and audit trails balance in either, a finished journal from one
  package returns its result in the other without the wire or the
  ledger, and a JAX party and a port party hold one session over
  loopback TCP.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcorr.protocol as jproto
import dpcorr_torch.protocol as pproto
from dpcorr import chaos as jchaos
from dpcorr.models.estimators import split_reference as jsr
from dpcorr.obs.audit import AuditTrail as JAuditTrail
from dpcorr.obs.audit import read_events as jread_events
from dpcorr.ops.standardize import priv_center as jax_priv_center
from dpcorr.protocol import messages as jmessages
from dpcorr.protocol import transport as jtransport
from dpcorr.serve.ledger import PrivacyLedger as JPrivacyLedger
from dpcorr.utils import rng as jrng
from dpcorr_torch import chaos, interop
from dpcorr_torch.models.estimators import split_reference as sr
from dpcorr_torch.models.estimators.registry import serving_entry
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.obs.audit import AuditTrail, read_events
from dpcorr_torch.protocol import (
    FaultInjector,
    InProcTransport,
    Message,
    ProtocolRefused,
    ProtocolSpec,
    ReleaseGate,
    ReliableChannel,
    SessionJournal,
    TransportError,
    canonical_encode,
    encode_array,
    ledger_balance,
    read_transcript,
    run_inproc,
    run_tcp,
    scan_transcript,
)
from dpcorr_torch.protocol.messages import Transcript
from dpcorr_torch.protocol.party import Party
from dpcorr_torch.protocol.scan import wire_schema
from dpcorr_torch.protocol.transport import tcp_accept, tcp_connect, tcp_listen
from dpcorr_torch.serve.ledger import PrivacyLedger
from dpcorr_torch.utils import rng

FAMILIES = ("ni_sign", "int_sign", "ni_subg", "int_subg")
EPS_ORDERS = [(1.0, 0.5), (0.5, 2.0)]
#: agreement with the JAX package: the estimator tests' bounds
ATOL, SUBG_RTOL, TIE = 1e-5, 2.5e-7, 1e-5


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    chaos.clear()
    yield
    chaos.clear()


def _columns(n=1500, rho=0.6, seed=99):
    r = np.random.default_rng(seed)
    xy = r.multivariate_normal([0.0, 0.0], [[1.0, rho], [rho, 1.0]],
                               size=n)
    return (np.asarray(xy[:, 0], np.float32),
            np.asarray(xy[:, 1], np.float32))


def _direct(family, x, y, eps1=1.0, eps2=0.5, seed=2025):
    """The port's monolithic estimator on the session's master key."""
    out = serving_entry(family, eps1, eps2, device="cpu")(
        rng.master_key(seed), torch.from_numpy(x), torch.from_numpy(y))
    return tuple(float(np.float32(v)) for v in out)


def _bits(res):
    return (res.rho_hat, res.ci_low, res.ci_high)


def _sign_near_tie(family, x, y, eps, key=None):
    """Does a privately centered value of either column sit within TIE
    of 0 (a sign another f32 summation order may flip)?"""
    if not family.endswith("sign"):
        return False
    prefix = "ni_sign" if family == "ni_sign" else "int_sign"
    k = jrng.master_key(2025) if key is None else key
    l_clip = float(np.sqrt(2.0 * np.log(len(x))))
    cx = jax_priv_center(jrng.stream(k, f"{prefix}/std_x"), jnp.asarray(x),
                         eps[0], l_clip)
    cy = jax_priv_center(jrng.stream(k, f"{prefix}/std_y"), jnp.asarray(y),
                         eps[1], l_clip)
    return bool((np.abs(np.asarray(cx)) < TIE).any()
                or (np.abs(np.asarray(cy)) < TIE).any())


def _agrees(family, got, want, x, y, eps) -> bool:
    rtol = SUBG_RTOL if family.endswith("subg") else 0.0
    return bool(np.isclose(got, want, rtol=rtol, atol=ATOL).all()) \
        or _sign_near_tie(family, x, y, eps)


# ----------------------------------------------------- split reference ----
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("eps", EPS_ORDERS)
def test_split_estimate_bit_equal_to_serving_entry(family, eps):
    """The factored estimator is bit-equal to the port's monolithic one,
    in both ε orders (the second swaps the INT sender)."""
    x, y = _columns()
    key = rng.master_key(2025)
    got = sr.split_estimate(family, key, key, x, y, *eps, device="cpu")
    assert tuple(float(v) for v in got) == _direct(family, x, y, *eps)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("eps", EPS_ORDERS)
def test_split_estimate_matches_jax(family, eps):
    x, y = _columns()
    key = rng.master_key(2025)
    got = [float(v) for v in sr.split_estimate(family, key, key, x, y,
                                               *eps, device="cpu")]
    jkey = jrng.master_key(2025)
    want = [float(v) for v in jsr.split_estimate(family, jkey, jkey, x, y,
                                                 *eps)]
    assert _agrees(family, got, want, x, y, eps), (got, want)


def test_release_and_wire_schemas_equal_jax():
    for family in FAMILIES:
        assert sr.split_roles(family, 0.5, 2.0) \
            == jsr.split_roles(family, 0.5, 2.0)
        for n in (64, 1500, 4096):
            for eps in ((1.0, 0.5), (0.25, 0.25), (5.0, 1.0)):
                want = jsr.release_schema(family, n, *eps)
                assert sr.release_schema(family, n, *eps) == want
                assert wire_schema(family, n, *eps) == want


def test_party_release_shapes_and_validation():
    x, _ = _columns(n=900)
    key = rng.master_key(3)
    for family in FAMILIES:
        releaser, finisher = sr.split_roles(family, 1.0, 0.5)
        rel = sr.party_release(family, key, releaser, x, 1.0, 0.5,
                               device="cpu")
        for name, want in sr.release_schema(family, 900, 1.0, 0.5).items():
            assert tuple(rel[name].shape) == want["shape"]
            assert rel[name].dtype == torch.float32
        if family.startswith("int"):
            assert sr.party_release(family, key, finisher, x, 1.0, 0.5,
                                    device="cpu") == {}
    with pytest.raises(ValueError, match="role"):
        sr.party_release("ni_sign", key, "z", x, 1.0, 0.5, device="cpu")
    with pytest.raises(ValueError, match="expected release payload"):
        sr.finish("ni_sign", key, {"ldp_values": x}, x, 1.0, 0.5,
                  device="cpu")


def test_party_release_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = _columns(n=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sr.party_release("ni_sign", rng.master_key(1), "x", x, 1.0, 0.5)
    spec = ProtocolSpec(family="ni_sign", n=64, eps1=1.0, eps2=0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inproc(spec, x, x)


@pytest.mark.parametrize("mode", ["replay", "hardened"])
def test_party_and_column_roots_bit_equal_to_jax(mode):
    # seeds outside [0, 2**32) wrap to their low word, as in JAX
    for seed in (0, 2025, 2**31 + 5, 2**33 + 5, -1):
        for label in ("", "a", "bmi"):
            key = rng.master_key(seed)
            jkey = jrng.master_key(seed)
            if label:
                key = rng.column_root(key, label)
                jkey = jrng.column_root(jkey, label)
            for role in ("x", "y"):
                np.testing.assert_array_equal(
                    interop.keys_to_jax_data(rng.party_root(key, role,
                                                            mode)),
                    np.asarray(jax.random.key_data(
                        jrng.party_root(jkey, role, mode))))
    with pytest.raises(ValueError):
        rng.party_root(rng.master_key(1), "z")
    with pytest.raises(ValueError):
        rng.party_root(rng.master_key(1), "x", "nope")
    with pytest.raises(ValueError):
        rng.column_root(rng.master_key(1), "")


def test_spec_hash_canonical_bytes_and_envelopes_equal_jax():
    kw = [dict(family="ni_sign", n=100, eps1=1.0, eps2=0.5),
          dict(family="int_subg", n=19433, eps1=0.5, eps2=2.0,
               noise_mode="hardened", seed=7),
          dict(family="ni_subg", n=512, eps1=1.0, eps2=1.0, key_x="a",
               key_y="c", party_x="p0", party_y="p1")]
    for k in kw:
        ours, theirs = ProtocolSpec(**k), jproto.ProtocolSpec(**k)
        assert ours.spec_hash() == theirs.spec_hash()
        assert ours.session == theirs.session
        assert ours.to_public() == theirs.to_public()
        for role in ("x", "y"):
            assert ours.charges_for(role) == theirs.charges_for(role)
    arr = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    env = encode_array(arr, "noisy_sign_batch_means")
    assert env == jmessages.encode_array(arr, "noisy_sign_batch_means")
    msg = Message("release", "x", "s", payload={"batch_means": env},
                  headers={"trace_id": "t", "span_id": "s"})
    jmsg = jproto.Message("release", "x", "s", payload={"batch_means": env},
                          headers={"trace_id": "t", "span_id": "s"})
    assert msg.encode() == jmsg.encode()
    assert canonical_encode({"b": [1.5, -0.0], "a": "é"}) \
        == jproto.canonical_encode({"b": [1.5, -0.0], "a": "é"})
    np.testing.assert_array_equal(
        jmessages.decode_array(env), arr)


# ------------------------------------------------------- protocol runs ----
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("eps", EPS_ORDERS)
def test_session_bit_equal_to_serving_entry(family, eps):
    x, y = _columns()
    spec = ProtocolSpec(family=family, n=len(x), eps1=eps[0], eps2=eps[1])
    res = run_inproc(spec, x, y, device="cpu")
    want = _direct(family, x, y, *eps)
    assert _bits(res["x"]) == want
    assert _bits(res["y"]) == want


def test_tcp_faulted_and_duplicated_sessions_same_bits():
    """TCP, drops/delays/duplicates (benchmarks/protocol_load.py's rates,
    shorter delay) and duplicate delivery give the in-process bits; the
    faulted arm really retransmitted."""
    x, y = _columns(n=1000)
    spec = ProtocolSpec(family="int_sign", n=len(x), eps1=0.5, eps2=2.0)
    clean = run_inproc(spec, x, y, device="cpu")
    assert _bits(clean["x"]) == _direct("int_sign", x, y, 0.5, 2.0)
    assert _bits(run_tcp(spec, x, y, device="cpu")["y"]) \
        == _bits(clean["y"])
    fault = {"drop": 0.25, "delay_s": 0.002, "duplicate": 0.2}
    chaotic = run_inproc(spec, x, y, fault=fault, timeout_s=0.25,
                         device="cpu")
    assert _bits(chaotic["x"]) == _bits(clean["x"])
    assert _bits(chaotic["y"]) == _bits(clean["y"])
    assert sum(r.stats["total_retries"] for r in chaotic.values()) > 0
    doubled = run_inproc(spec, x, y, fault={"duplicate": 1.0},
                         timeout_s=0.2, device="cpu")
    assert _bits(doubled["x"]) == _bits(clean["x"])


def test_hardened_mode_agrees_but_differs_from_replay():
    x, y = _columns()
    spec = ProtocolSpec(family="ni_sign", n=len(x), eps1=1.0, eps2=0.5,
                        noise_mode="hardened")
    res = run_inproc(spec, x, y, device="cpu")
    assert _bits(res["x"]) == _bits(res["y"])
    assert np.isfinite(_bits(res["x"])).all()
    assert _bits(res["x"]) != _direct("ni_sign", x, y)


def test_ledger_refusal_mid_protocol_no_partial_release(tmp_path):
    x, y = _columns()
    spec = ProtocolSpec(family="ni_subg", n=len(x), eps1=1.0, eps2=0.5)
    lx, ly = PrivacyLedger(100.0), PrivacyLedger(0.2)  # y needs 0.5
    with pytest.raises(ProtocolRefused):
        run_inproc(spec, x, y, ledger_x=lx, ledger_y=ly,
                   transcript_dir=str(tmp_path), device="cpu")
    assert ly.snapshot()["parties"] == {}
    assert lx.snapshot()["parties"]["party-x"]["spent"] == 1.0
    for role in ("x", "y"):
        types = [e["wire"]["msg_type"] for e in read_transcript(
            str(tmp_path / f"{spec.session}.{role}.jsonl"))]
        assert "result" not in types and "error" in types


def test_transcript_determinism_and_trace_propagation(tmp_path):
    x, y = _columns()
    spec = ProtocolSpec(family="ni_sign", n=len(x), eps1=1.0, eps2=0.5)
    dirs = [tmp_path / "a", tmp_path / "b"]
    for d in dirs:
        run_inproc(spec, x, y, transcript_dir=str(d), device="cpu")
    for role in ("x", "y"):
        wires = [[json.dumps(e["wire"], sort_keys=True)
                  for e in read_transcript(
                      str(d / f"{spec.session}.{role}.jsonl"))]
                 for d in dirs]
        assert wires[0] == wires[1]
    path = str(tmp_path / "spans.jsonl")
    obs_trace.configure(path)
    try:
        res = run_inproc(spec, x, y, device="cpu")
    finally:
        obs_trace.configure(None)
    assert res["x"].trace_id is not None
    assert res["x"].trace_id == res["y"].trace_id
    spans = [json.loads(line) for line in open(path)]
    assert {s["trace_id"] for s in spans} == {res["x"].trace_id}
    assert {"protocol.release", "protocol.finish"} <= {s["name"]
                                                      for s in spans}


# -------------------------------------------------- files, both ways ----
def test_transcripts_scan_clean_and_balance_both_ways(tmp_path):
    """A port transcript passes the JAX auditor (schema, no raw columns,
    ε balance against the port's trail), and a JAX one the port's."""
    x, y = _columns()
    spec = ProtocolSpec(family="int_subg", n=len(x), eps1=1.0, eps2=0.5)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    trails = {r: AuditTrail(str(tmp_path / f"port.{r}.jsonl"))
              for r in ("x", "y")}
    run_inproc(spec, x, y, transcript_dir=str(pdir), device="cpu",
               ledger_x=PrivacyLedger(100.0, audit=trails["x"]),
               ledger_y=PrivacyLedger(100.0, audit=trails["y"]))
    jtrails = {r: JAuditTrail(str(tmp_path / f"jax.{r}.jsonl"))
               for r in ("x", "y")}
    jproto.run_inproc(jproto.ProtocolSpec(family="int_subg", n=len(x),
                                          eps1=1.0, eps2=0.5), x, y,
                      transcript_dir=str(jdir),
                      ledger_x=JPrivacyLedger(100.0, audit=jtrails["x"]),
                      ledger_y=JPrivacyLedger(100.0, audit=jtrails["y"]))
    spent = {}
    for role in ("x", "y"):
        ours = str(pdir / f"{spec.session}.{role}.jsonl")
        theirs = str(jdir / f"{spec.session}.{role}.jsonl")
        for path, audit in ((ours, str(tmp_path / f"port.{role}.jsonl")),
                            (theirs, str(tmp_path / f"jax.{role}.jsonl"))):
            for scan, balance, events in (
                    (scan_transcript, ledger_balance, read_events),
                    (jproto.scan_transcript, jproto.ledger_balance,
                     jread_events)):
                rep = scan(path, raw_x=x, raw_y=y)
                assert rep["ok"], (path, rep["violations"])
                bal = balance(path, events(audit))
                assert bal["ok"], (path, bal)
                spent.update(bal["spent"])
        # the two packages' wires differ only in the released floats
        assert [e["wire"]["msg_type"] for e in read_transcript(ours)] \
            == [e["wire"]["msg_type"] for e in read_transcript(theirs)]
    assert spent == {"party-x": 1.0, "party-y": 0.5}


def test_scan_flags_raw_column_on_a_port_transcript(tmp_path):
    x, y = _columns()
    spec = ProtocolSpec(family="int_sign", n=len(x), eps1=1.0, eps2=0.5)
    run_inproc(spec, x, y, transcript_dir=str(tmp_path), device="cpu")
    entries = read_transcript(str(tmp_path / f"{spec.session}.x.jsonl"))
    for e in entries:
        if e["wire"]["msg_type"] == "release":
            e["wire"]["payload"]["flipped_signs"] = encode_array(
                x, "rr_flipped_signs")
    for scan in (scan_transcript, jproto.scan_transcript):
        rep = scan(entries, raw_x=x, raw_y=y)
        assert any(v["rule"] == "raw-column-on-wire"
                   for v in rep["violations"])


class _DeadChannel:
    """A channel a finished journal must never touch."""

    fault = None
    total_retries = 0
    sent_msgs = 0
    peer_resumed = False
    timeout_s = 1.0

    def __getattr__(self, name):
        raise AssertionError(f"the wire was touched: {name}")


def _journaled_session(pkg, spec, x, y, tmp_path, tag):
    """One journaled session driven party by party (``pkg`` is the JAX
    protocol package or the port's); returns the results and the files."""
    pair = pkg.InProcTransport()
    paths = {r: {"journal": str(tmp_path / f"{tag}.journal.{r}.json"),
                 "ledger": str(tmp_path / f"{tag}.ledger.{r}.json")}
             for r in ("x", "y")}
    ledger_cls = PrivacyLedger if pkg is not jproto else JPrivacyLedger
    kw = {} if pkg is jproto else {"device": "cpu"}
    parties = [pkg.Party(r, c, spec, pkg.ReliableChannel(link, timeout_s=2.0),
                         ledger_cls(100.0, path=paths[r]["ledger"]),
                         journal=pkg.SessionJournal(paths[r]["journal"]),
                         **kw)
               for r, c, link in (("x", x, pair.a), ("y", y, pair.b))]
    results = {}
    threads = [threading.Thread(
        target=lambda p=p: results.__setitem__(p.role, p.run()))
        for p in parties]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, paths


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_finished_journal_and_ledger_read_in_the_other_package(writer,
                                                               tmp_path):
    x, y = _columns(n=600)
    kw = dict(family="ni_sign", n=len(x), eps1=1.0, eps2=0.5)
    pkg, other = (jproto, "port") if writer == "jax" else (pproto, "jax")
    results, paths = _journaled_session(pkg, pkg.ProtocolSpec(**kw), x, y,
                                        tmp_path, writer)
    for role, col in (("x", x), ("y", y)):
        if other == "port":
            ledger = PrivacyLedger(100.0, path=paths[role]["ledger"])
            party = Party(role, col, ProtocolSpec(**kw), _DeadChannel(),
                          ledger,
                          journal=SessionJournal(paths[role]["journal"]),
                          device="cpu")
        else:
            ledger = JPrivacyLedger(100.0, path=paths[role]["ledger"])
            party = jproto.Party(
                role, col, jproto.ProtocolSpec(**kw), _DeadChannel(),
                ledger,
                journal=jproto.SessionJournal(paths[role]["journal"]))
        before = ledger.snapshot()
        got = party.run()
        assert _bits(got) == _bits(results[role])
        assert ledger.snapshot() == before
        assert before["parties"] != {}


@pytest.mark.parametrize("jax_role", ["x", "y"])
def test_mixed_jax_and_port_session_over_tcp(jax_role):
    """A JAX party and a port party hold one session over loopback TCP
    (each with its own package's link and channel); both roles get the
    same answer, within tolerance of the JAX-only session."""
    x, y = _columns(n=1000)
    eps = (1.0, 0.5)
    kw = dict(family="ni_sign", n=len(x), eps1=eps[0], eps2=eps[1])
    # y listens and x dials, each with its own package's link
    if jax_role == "y":
        listen, accept, dial = (jtransport.tcp_listen,
                                jtransport.tcp_accept, tcp_connect)
    else:
        listen, accept, dial = (tcp_listen, tcp_accept,
                                jtransport.tcp_connect)
    srv, port = listen("127.0.0.1", 0)
    links = {}
    acceptor = threading.Thread(
        target=lambda: links.__setitem__("y", accept(srv, timeout_s=30.0)))
    acceptor.start()
    links["x"] = dial("127.0.0.1", port, timeout_s=30.0)
    acceptor.join()
    srv.close()

    def make(role, col):
        if role == jax_role:
            return jproto.Party(role, col, jproto.ProtocolSpec(**kw),
                                jproto.ReliableChannel(links[role],
                                                       timeout_s=5.0),
                                JPrivacyLedger(100.0))
        return Party(role, col, ProtocolSpec(**kw),
                     ReliableChannel(links[role], timeout_s=5.0),
                     PrivacyLedger(100.0), device="cpu")

    results, errors = {}, {}

    def drive(p):
        try:
            results[p.role] = p.run()
        except BaseException as e:  # re-raised below
            errors[p.role] = e

    threads = [threading.Thread(target=drive, args=(make(r, c),))
               for r, c in (("x", x), ("y", y))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        for link in links.values():
            link.close()
    assert not errors, errors
    assert _bits(results["x"]) == _bits(results["y"])
    want = _bits(jproto.run_inproc(jproto.ProtocolSpec(**kw), x, y)["x"])
    assert _agrees("ni_sign", _bits(results["x"]), want, x, y, eps)


# ----------------------------------------------------- gate and chaos ----
class _FailingChannel:
    fault = None
    total_retries = 0

    def send(self, body):
        raise TransportError("wire down")


def test_gate_charges_before_send_and_refunds_on_failure():
    ledger = PrivacyLedger(10.0)
    gate = ReleaseGate(ledger)
    with pytest.raises(TransportError):
        gate.send_release(_FailingChannel(), {"k": 1}, {"party-x": 2.0})
    assert ledger.snapshot()["parties"]["party-x"]["spent"] == 0.0
    seen = {}

    class Channel:
        fault = None
        total_retries = 0

        def send(self, body):
            seen["spent"] = ledger.spent("party-x")
            return {"seq": 1, "retries": 0, "latency_s": 0.0, "bytes": 10}

    assert gate.send_release(Channel(), {"k": 1},
                             {"party-x": 2.0})["eps"] == 2.0
    assert seen["spent"] == 2.0


def test_reliable_channel_dedupes_and_fault_plans_match_jax():
    pair = InProcTransport()
    a = ReliableChannel(pair.a, timeout_s=1.0,
                        fault=FaultInjector(duplicate=1.0, seed=5))
    b = ReliableChannel(pair.b, timeout_s=1.0)
    got = []
    for i in range(3):
        t = threading.Thread(
            target=lambda: got.append(b.recv(timeout_s=2.0)["body"]["i"]))
        t.start()
        a.send({"i": i})
        t.join()
    assert got == [0, 1, 2] and len(b._delivered) == 3
    for kw in ({"drop": 0.3, "duplicate": 0.3, "delay_s": 0.01, "seed": 42},
               {"drop": 0.1, "delay_s": 0.05, "duplicate": 0.05,
                "seed": 11}):
        assert FaultInjector(**kw).plan() \
            == jtransport.FaultInjector(**kw).plan()


def test_chaos_points_and_seeded_plans_equal_jax():
    assert chaos.KNOWN_POINTS == jchaos.KNOWN_POINTS
    assert chaos.MATRIX_POINTS == jchaos.MATRIX_POINTS
    for seed in range(100):
        ours, theirs = chaos.plan_from_seed(seed), jchaos.plan_from_seed(seed)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.to_spec() == theirs.to_spec()
    for spec in ("point=gate.post_charge,hit=2,mode=raise,role=y",
                 "seed=7,role=x", "seed=3,mode=raise"):
        assert chaos.plan_from_spec(spec).to_dict() \
            == jchaos.plan_from_spec(spec).to_dict()
    with pytest.raises(ValueError, match="neither"):
        chaos.plan_from_spec("hit=1")


def test_unreachable_points_are_refused(monkeypatch, tmp_path):
    """No point is unreachable any more: with the fleet lease ported,
    ``UNREACHABLE_POINTS`` is empty, every matrix point is reachable, and
    a plan on the fleet's point, armed from the environment, fires inside
    the lease manager; an unknown point is still refused."""
    from dpcorr_torch.serve.fleet import LeaseManager

    assert chaos.UNREACHABLE_POINTS == frozenset()
    assert [p for p in chaos.MATRIX_POINTS
            if p not in chaos.UNREACHABLE_POINTS] == list(chaos.MATRIX_POINTS)
    monkeypatch.setenv("DPCORR_CHAOS",
                       "point=fleet.pre_lease_commit,mode=raise")
    chaos.install(chaos.plan_from_env())
    try:
        with pytest.raises(chaos.SimulatedCrash):
            LeaseManager(str(tmp_path / "leases"), "r", n_shards=1
                         ).acquire(0)
    finally:
        chaos.clear()
    with pytest.raises(ValueError, match="unknown chaos point"):
        chaos.ChaosPlan("fleet.no_such_point")


@pytest.mark.parametrize("point,victim", [
    ("gate.post_charge", "y"), ("gate.post_send", "x"),
    ("journal.post_prepare", "x"), ("party.post_handshake", "y")])
def test_crash_resume_exactly_once(point, victim, tmp_path):
    """A raise-mode kill of one party at a protocol crash point, then a
    fresh party on the same journal and ledger file: both roles end with
    the uninterrupted bits, each role's ε charged once, transcripts clean
    and balanced."""
    x, y = _columns(n=512)
    spec = ProtocolSpec(family="ni_sign", n=len(x), eps1=1.0, eps2=0.5,
                        session=f"cr-{victim}-{point}")
    ref = run_inproc(spec, x, y, device="cpu")
    pair = InProcTransport()
    links, cols = {"x": pair.a, "y": pair.b}, {"x": x, "y": y}
    paths = {r: {k: str(tmp_path / f"{k}-{r}.{ext}") for k, ext in
                 (("ledger", "json"), ("journal", "json"),
                  ("audit", "jsonl"), ("transcript", "jsonl"))}
             for r in ("x", "y")}

    def mk_party(role):
        chan = ReliableChannel(links[role], timeout_s=0.1, max_retries=400,
                               backoff_base_s=0.02, backoff_max_s=0.1)
        ledger = PrivacyLedger(100.0, path=paths[role]["ledger"],
                               audit=AuditTrail(paths[role]["audit"]))
        return Party(role, cols[role], spec, chan, ledger,
                     transcript=Transcript(paths[role]["transcript"]),
                     recv_timeout_s=60.0,
                     journal=SessionJournal(paths[role]["journal"]),
                     device="cpu")

    results, errors = {}, {}

    def drive(party):
        try:
            results[party.role] = party.run()
        except BaseException as e:  # SimulatedCrash is a BaseException
            errors[party.role] = e

    survivor = "y" if victim == "x" else "x"
    chaos.install(chaos.ChaosPlan(point=point, hit=1, mode="raise",
                                  thread_name=f"party-{victim}"))
    t_surv = threading.Thread(target=drive, args=(mk_party(survivor),),
                              name=f"party-{survivor}")
    t_vict = threading.Thread(target=drive, args=(mk_party(victim),),
                              name=f"party-{victim}")
    try:
        t_surv.start()
        t_vict.start()
        t_vict.join(timeout=60)
        assert isinstance(errors.pop(victim, None), chaos.SimulatedCrash)
    finally:
        chaos.clear()
    t_restart = threading.Thread(target=drive, args=(mk_party(victim),),
                                 name=f"party-{victim}")
    t_restart.start()
    t_surv.join(timeout=60)
    t_restart.join(timeout=60)
    assert not errors, errors
    for role in ("x", "y"):
        assert _bits(results[role]) == _bits(ref[role])
        assert scan_transcript(paths[role]["transcript"])["ok"]
        assert ledger_balance(paths[role]["transcript"],
                              read_events(paths[role]["audit"]))["ok"]
        with open(paths[role]["ledger"]) as fh:
            spent = json.load(fh)["spent"]
        for name, eps in spec.charges_for(role).items():
            assert spent[name] == pytest.approx(eps)
        # the JAX package reads the resumed ledger to the same spend
        assert JPrivacyLedger(100.0, path=paths[role]["ledger"]).spent(
            spec.party_name(role)) == pytest.approx(
                sum(spec.charges_for(role).values()))


@pytest.mark.parametrize("point", ["budget.pre_journal",
                                   "budget.post_journal",
                                   "budget.mid_compaction",
                                   "budget.mid_eviction"])
def test_budget_points_crash_resume_with_a_user_directory(point, tmp_path):
    """The gate charges a CompositeLedger (a user leg in a per-user budget
    directory, compacting and evicting on every charge, as the JAX
    package's chaos command arms it): a raise-mode kill of y at each
    budget point, then a fresh y on the same files, gives the
    uninterrupted bits with y's party and user legs charged once."""
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.serve.budget_dir import BudgetDirectory, CompositeLedger

    x, y = _columns(n=512)
    spec = ProtocolSpec(family="ni_subg", n=len(x), eps1=1.0, eps2=0.5,
                        session=f"bd-{point}")
    ref = run_inproc(spec, x, y, device="cpu")
    pair = InProcTransport()
    links, cols = {"x": pair.a, "y": pair.b}, {"x": x, "y": y}
    paths = {r: {k: str(tmp_path / f"{k}-{r}.{ext}") for k, ext in
                 (("ledger", "json"), ("journal", "json"),
                  ("audit", "jsonl"), ("transcript", "jsonl"))}
             for r in ("x", "y")}

    def mk_party(role):
        chan = ReliableChannel(links[role], timeout_s=0.1, max_retries=400,
                               backoff_base_s=0.02, backoff_max_s=0.1)
        audit = AuditTrail(paths[role]["audit"])
        ledger = PrivacyLedger(100.0, path=paths[role]["ledger"],
                               audit=audit)
        if role == "y":
            ledger = CompositeLedger(ledger, BudgetDirectory(
                str(tmp_path / "users-y"), shards=2, user_budget=100.0,
                max_resident=0, compact_every=1, fsync=False, audit=audit),
                user="user-y")
        return Party(role, cols[role], spec, chan, ledger,
                     transcript=Transcript(paths[role]["transcript"]),
                     recv_timeout_s=60.0,
                     journal=SessionJournal(paths[role]["journal"]),
                     device="cpu")

    results, errors = {}, {}

    def drive(party):
        try:
            results[party.role] = party.run()
        except BaseException as e:  # SimulatedCrash is a BaseException
            errors[party.role] = e

    chaos.install(chaos.ChaosPlan(point=point, hit=1, mode="raise",
                                  thread_name="party-y"))
    t_x = threading.Thread(target=drive, args=(mk_party("x"),),
                           name="party-x")
    t_y = threading.Thread(target=drive, args=(mk_party("y"),),
                           name="party-y")
    try:
        t_x.start()
        t_y.start()
        t_y.join(timeout=60)
        assert isinstance(errors.pop("y", None), chaos.SimulatedCrash)
    finally:
        chaos.clear()
    t_restart = threading.Thread(target=drive, args=(mk_party("y"),),
                                 name="party-y")
    t_restart.start()
    t_x.join(timeout=60)
    t_restart.join(timeout=60)
    assert not errors, errors
    for role in ("x", "y"):
        assert _bits(results[role]) == _bits(ref[role])
    want = sum(spec.charges_for("y").values())
    with open(paths["y"]["ledger"]) as fh:
        assert sum(json.load(fh)["spent"].values()) == pytest.approx(want)
    assert read_user_balances(str(tmp_path / "users-y"))["user-y"]["l"] \
        == pytest.approx(want)


def test_protocol_transcript_frame_matches_jax(tmp_path):
    pytest.importorskip("pandas")
    from dpcorr.report import protocol_transcript_frame as jframe
    from dpcorr_torch.report import protocol_transcript_frame

    x, y = _columns()
    spec = ProtocolSpec(family="ni_sign", n=len(x), eps1=1.0, eps2=0.5)
    run_inproc(spec, x, y, transcript_dir=str(tmp_path), device="cpu")
    path = str(tmp_path / f"{spec.session}.x.jsonl")
    got, want = protocol_transcript_frame(path), jframe(path)
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert list(got[col]) == list(want[col]), col
    assert list(got["type"]) == ["hello", "hello_ack", "release", "result"]
    assert got["eps"].dtype == np.float64
    assert float(got["eps"][got["eps"] > 0][0]) == 2.0
