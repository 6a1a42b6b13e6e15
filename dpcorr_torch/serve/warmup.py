"""Serve warmup: the signature set made resident ahead of traffic.

Counterpart of ``dpcorr/serve/warmup.py``, with its spec syntax and
manifest format (version 1), so a manifest written by either package
warms the other. The operator names the expected signatures (CLI
``--warmup`` spec and/or a manifest the previous run persisted on
shutdown), a background thread builds them through the single-flight
kernel cache, and ``GET /readyz`` reports ready only once the set is
resident — the standard readiness-gate shape. Building an entry here
compiles nothing (eager torch), so the gate is cheap; it is kept because
the JAX package's operators and load balancers rely on it.

Two sources, merged and deduplicated:

- **spec strings** — ``family:n:eps1:eps2[:bpads[:alpha[:normalise]]]``
  entries separated by ``;`` (or whitespace). ``bpads`` is a
  comma-separated list of batch widths to warm (each rounded up to its
  power-of-two bucket), or ``auto``: every power of two from 1 up to
  the server's ``max_batch`` — the full set steady traffic can flush.
  Example: ``ni_sign:500:1.0:0.5:auto;int_subg:1000:1.0:1.0:1,64``.
- **manifest files** — JSON written by :func:`save_manifest` from
  ``KernelCache.manifest()`` on server shutdown; replaying it on boot
  warms exactly the working set the previous process served.

Warmup entries are *signatures*, not queries: nothing is charged to any
ledger and no noise stream is consumed. With the cache's ``aot`` on,
each signature is also run once on :func:`example_args` (zero keys and
fixed data, made for the purpose) so its first launch is paid before
``/readyz`` turns 200.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from dpcorr_torch.serve.kernels import pad_batch
from dpcorr_torch.serve.request import KernelKey
from dpcorr_torch.utils import rng

log = logging.getLogger("dpcorr.serve")

MANIFEST_VERSION = 1


def _parse_bpads(tok: str, max_batch: int) -> list[int]:
    if tok == "auto":
        out, b = [], 1
        while b <= max_batch:
            out.append(b)
            b *= 2
        return out
    return [pad_batch(int(t)) for t in tok.split(",") if t]


def parse_warmup_spec(spec: str, max_batch: int) -> list[dict]:
    """``--warmup`` spec string → signature dicts (manifest shape).
    Raises ValueError on malformed entries — a typo'd warmup silently
    warming nothing defeats its purpose."""
    sigs: list[dict] = []
    for entry in spec.replace(";", " ").split():
        parts = entry.split(":")
        if not 4 <= len(parts) <= 7:
            raise ValueError(
                f"bad --warmup entry {entry!r}: expected "
                "family:n:eps1:eps2[:bpads[:alpha[:normalise]]]")
        family, n, e1, e2 = parts[0], int(parts[1]), float(parts[2]), \
            float(parts[3])
        bpads = _parse_bpads(parts[4] if len(parts) > 4 and parts[4]
                             else "auto", max_batch)
        alpha = float(parts[5]) if len(parts) > 5 else 0.05
        normalise = parts[6].lower() in ("1", "true", "yes") \
            if len(parts) > 6 else True
        for b_pad in bpads:
            sigs.append({"family": family, "n": n, "eps1": e1, "eps2": e2,
                         "alpha": alpha, "normalise": normalise,
                         "b_pad": b_pad})
    return sigs


def signatures_to_keys(sigs: list[dict]) -> list[tuple[KernelKey, int]]:
    """Signature dicts → deduplicated ``(KernelKey, b_pad)`` warm list,
    order-preserving (first-mentioned builds first)."""
    seen, out = set(), []
    for s in sigs:
        kkey = KernelKey(str(s["family"]), int(s["n"]),
                         float(s["eps1"]), float(s["eps2"]),
                         float(s.get("alpha", 0.05)),
                         bool(s.get("normalise", True)))
        item = (kkey, pad_batch(int(s["b_pad"])))
        if item not in seen:
            seen.add(item)
            out.append(item)
    return out


def example_args(kkey: KernelKey, b_pad: int, mode: str) -> tuple:
    """Host ``(keys, xs, ys)`` at one signature's dispatch shape for its
    warm run: the vector engine's ``b_pad`` lanes, or one lane for the
    exact engine, which runs the single call lane by lane (one lane
    makes every launch of the body). The keys are zero words, as many
    as the process impl's keys have (``rng.process_impl``), derived from
    no ledger's key-tree; the data is a fixed normal draw."""
    lanes = b_pad if mode == "vector" else 1
    data = np.random.default_rng(0).standard_normal(
        (2, lanes, kkey.n)).astype(np.float32)
    words = rng.IMPLS[rng.process_impl()]
    return np.zeros((lanes, words), np.int64), data[0], data[1]


def load_manifest(path: str) -> list[dict]:
    """Read a kernel-cache manifest; missing file → empty (first boot),
    unreadable/mismatched-version → empty with a warning (a stale
    manifest must degrade to a cold boot, never crash the server)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return []
    except (OSError, json.JSONDecodeError) as e:
        log.warning("warmup manifest %s unreadable (%s); cold boot", path, e)
        return []
    if not isinstance(doc, dict) \
            or doc.get("version") != MANIFEST_VERSION \
            or not isinstance(doc.get("signatures"), list):
        log.warning("warmup manifest %s has unknown shape/version; "
                    "cold boot", path)
        return []
    return [s for s in doc["signatures"] if isinstance(s, dict)]


def save_manifest(path: str, sigs: list[dict]) -> None:
    """Persist the resident signature set (atomic tmp+rename)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": MANIFEST_VERSION, "signatures": sigs}, f,
                  indent=2)
    os.replace(tmp, path)
