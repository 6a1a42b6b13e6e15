"""Drive both protocol roles from one process (tests, benchmarks, CLI).

Counterpart of ``dpcorr/protocol/runner.py``. Both parties compute on one
``device`` (the card unless ``device="cpu"``); their threads share its
default stream.

The genuine deployment is two processes (``python -m dpcorr_torch party``
twice); this module runs the same :class:`~dpcorr_torch.protocol.party.Party`
code on two threads over either transport, which is what the
bit-identity tests, the chaos benchmark and the single-command
``python -m dpcorr_torch protocol run`` use. Each party still gets its *own*
ledger, transcript and channel endpoint — nothing is shared except the
wire — so the in-process mode exercises the identical code paths the
two-process mode does, TCP handshake included.
"""

from __future__ import annotations

import os
import threading

from dpcorr_torch.protocol.messages import Transcript
from dpcorr_torch.protocol.party import Party, ProtocolResult, ProtocolSpec
from dpcorr_torch.protocol.transport import (
    FaultInjector,
    InProcTransport,
    ReliableChannel,
    tcp_accept,
    tcp_connect,
    tcp_listen,
)
from dpcorr_torch.serve.ledger import PrivacyLedger
from dpcorr_torch.utils.device import resolve_device

#: Default per-party budget when the caller doesn't bring a ledger —
#: high enough that single-session runs never refuse by accident, real
#: deployments pass their own persistent ledgers.
DEFAULT_BUDGET = 1e6


def _mk_fault(fault: dict | None, default_seed: int) -> FaultInjector | None:
    """Build one side's injector from a shared fault spec; each side
    gets a distinct stdlib-RNG seed so their chaos is independent. A
    caller-supplied base seed (``fault["seed"]``, the CLI's
    ``--fault-seed``) is folded with the per-side default so one knob
    reproduces *both* sides' fault sequences."""
    if not fault:
        return None
    base = fault.get("seed")
    seed = default_seed if base is None \
        else int(base) * 1000003 + default_seed
    return FaultInjector(drop=fault.get("drop", 0.0),
                         delay_s=fault.get("delay_s", 0.0),
                         duplicate=fault.get("duplicate", 0.0),
                         delay_rate=fault.get("delay_rate", 1.0),
                         seed=seed)


def _transcript(transcript_dir: str | None, spec: ProtocolSpec,
                role: str) -> Transcript:
    if not transcript_dir:
        return Transcript(None)
    return Transcript(os.path.join(
        transcript_dir, f"{spec.session}.{role}.jsonl"))


def _run_pair(party_x: Party, party_y: Party) -> dict:
    """Run both parties to completion on two threads; re-raises the
    first party error (protocol refusals included) after both joined."""
    results: dict[str, ProtocolResult] = {}
    errors: dict[str, BaseException] = {}

    def drive(party: Party) -> None:
        try:
            results[party.role] = party.run()
        except BaseException as e:  # captured for the joining thread
            errors[party.role] = e

    threads = [threading.Thread(target=drive, args=(p,),
                                name=f"party-{p.role}")
               for p in (party_x, party_y)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        role = "x" if "x" in errors else "y"
        raise errors[role]
    return results


def _make_parties(spec: ProtocolSpec, x, y, link_x, link_y,
                  ledger_x, ledger_y, fault, transcript_dir,
                  timeout_s, max_retries, device) -> tuple[Party, Party]:
    # scale the backoff ceiling with the ack window: short-timeout
    # chaos runs then retransmit (and drain-linger, transport.drain)
    # on a proportionally short cadence instead of parking for the
    # full 2 s default between late attempts
    backoff_max = min(2.0, max(2.0 * timeout_s, 0.1))
    chan_x = ReliableChannel(link_x, timeout_s=timeout_s,
                             max_retries=max_retries,
                             backoff_max_s=backoff_max,
                             fault=_mk_fault(fault, default_seed=11))
    chan_y = ReliableChannel(link_y, timeout_s=timeout_s,
                             max_retries=max_retries,
                             backoff_max_s=backoff_max,
                             fault=_mk_fault(fault, default_seed=23))
    ledger_x = ledger_x or PrivacyLedger(DEFAULT_BUDGET)
    ledger_y = ledger_y or PrivacyLedger(DEFAULT_BUDGET)
    tx = _transcript(transcript_dir, spec, "x")
    ty = _transcript(transcript_dir, spec, "y")
    if fault:
        # reproducibility-from-the-artifact: a chaos failure's fault
        # config (seed included) is in the transcript header itself
        header = {"fault": {k: v for k, v in fault.items()},
                  "session": spec.session}
        tx.meta(**header)
        ty.meta(**header)
    px = Party("x", x, spec, chan_x, ledger_x, transcript=tx,
               device=device)
    py = Party("y", y, spec, chan_y, ledger_y, transcript=ty,
               device=device)
    return px, py


def run_inproc(spec: ProtocolSpec, x, y, *,
               ledger_x: PrivacyLedger | None = None,
               ledger_y: PrivacyLedger | None = None,
               fault: dict | None = None,
               transcript_dir: str | None = None,
               timeout_s: float = 10.0,
               max_retries: int = 10, device=None) -> dict:
    """Both roles over the queue-pair transport, on ``device`` (the card
    unless the caller names another). Returns
    ``{"x": ProtocolResult, "y": ProtocolResult}``."""
    pair = InProcTransport()
    px, py = _make_parties(spec, x, y, pair.a, pair.b, ledger_x,
                           ledger_y, fault, transcript_dir, timeout_s,
                           max_retries, device)
    return _run_pair(px, py)


def run_tcp(spec: ProtocolSpec, x, y, *, host: str = "127.0.0.1",
            port: int = 0,
            ledger_x: PrivacyLedger | None = None,
            ledger_y: PrivacyLedger | None = None,
            fault: dict | None = None,
            transcript_dir: str | None = None,
            timeout_s: float = 10.0,
            max_retries: int = 10, device=None) -> dict:
    """Both roles over a real loopback TCP socket (length-prefixed
    frames, full handshake), on ``device``. ``port=0`` picks an
    ephemeral port."""
    resolve_device(device)  # raise before any socket opens
    srv, bound = tcp_listen(host, port)
    links: dict[str, object] = {}

    def accept() -> None:
        links["y"] = tcp_accept(srv, timeout_s=max(timeout_s, 30.0))

    acceptor = threading.Thread(target=accept, name="tcp-accept")
    acceptor.start()
    links["x"] = tcp_connect(host, bound, timeout_s=max(timeout_s, 30.0))
    acceptor.join()
    srv.close()
    px, py = _make_parties(spec, x, y, links["x"], links["y"], ledger_x,
                           ledger_y, fault, transcript_dir, timeout_s,
                           max_retries, device)
    try:
        return _run_pair(px, py)
    finally:
        links["x"].close()
        links["y"].close()
