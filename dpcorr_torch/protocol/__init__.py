"""The two-party protocol and the N-party federation: the privacy
barrier as a wire.

Counterpart of ``dpcorr/protocol/``, with the same modules, names, wire
format and files: a JAX party and a port party can hold one session, and
journals, ledgers, audit trails, transcripts and federation plans are
read by both packages.

- :mod:`messages`: versioned message schema, canonical bytes, array
  envelopes, the JSONL transcript each party keeps;
- :mod:`transport`: queue-pair and TCP links with length-prefixed frames;
  :class:`ReliableChannel` adds timeouts, bounded retries, sequence
  numbers with idempotent redelivery and seeded fault injection;
- :mod:`gate`: :class:`ReleaseGate` charges the ledger before a release
  is sent and refunds it when delivery fails;
- :mod:`journal`: the crash-safe session state a restarted party resumes
  from;
- :mod:`party`: the X and Y roles of the four families' protocols; each
  party computes only its own column's release
  (``models.estimators.split_reference``), on its device;
- :mod:`runner`: both roles in one process, over queue pairs or loopback
  TCP (``python -m dpcorr_torch protocol run``);
- :mod:`scan`: the offline transcript auditor (schema, no raw columns,
  the ε balance);
- :mod:`matrix` and :mod:`federation`: the k×k correlation matrix over
  multiplexed pair sessions at the release-reuse ε optimum.

Under the ``"replay"`` key layout a session is bit-equal to the port's
monolithic estimator on the same master key and device
(``tests/test_torch_protocol.py`` on the CPU, ``tests/test_torch_cuda.py``
on the card).
"""

# Exports resolve lazily (PEP 562): the party and runner layers reach the
# estimators (and therefore torch) at import time, but the scan layer
# must stay importable where torch is not installed: the auditor runs
# where the estimators cannot.
_EXPORTS = {
    "FederationParty": "federation",
    "FederationResult": "federation",
    "LinkBroker": "federation",
    "dial_link": "federation",
    "make_federation_parties": "federation",
    "run_federation_inproc": "federation",
    "run_federation_tcp": "federation",
    "serve_federation_party": "federation",
    "ReleaseGate": "gate",
    "JournalError": "journal",
    "SessionJournal": "journal",
    "FederationPlan": "matrix",
    "PROTOCOL_VERSION": "messages",
    "Message": "messages",
    "Transcript": "messages",
    "canonical_encode": "messages",
    "decode_array": "messages",
    "encode_array": "messages",
    "read_transcript": "messages",
    "read_transcript_meta": "messages",
    "Party": "party",
    "ProtocolError": "party",
    "ProtocolRefused": "party",
    "ProtocolResult": "party",
    "ProtocolSpec": "party",
    "run_inproc": "runner",
    "run_tcp": "runner",
    "federation_balance": "scan",
    "ledger_balance": "scan",
    "scan_federation": "scan",
    "scan_transcript": "scan",
    "FaultInjector": "transport",
    "InProcTransport": "transport",
    "ReconnectingTcpLink": "transport",
    "ReliableChannel": "transport",
    "TransportError": "transport",
    "TransportTimeout": "transport",
    "tcp_connect": "transport",
    "tcp_listen": "transport",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(
        importlib.import_module(f"dpcorr_torch.protocol.{submodule}"), name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
