"""Replica supervision: boot, monitor, restart with identical argv.

Counterpart of ``dpcorr/serve/fleet/supervisor.py``. The fleet's process
manager. Each replica is a real ``python -m dpcorr_torch serve``
subprocess that prints a one-line JSON banner after binding; the
supervisor reads the banner to learn the bound port (replicas run
``--port 0``), then watches the process and — when it dies for any
reason, including the SIGKILL the failover drill throws — relaunches it
with the SAME argv. Identical argv is the failover contract: the
restarted replica reopens the same ledger/audit/WAL paths, recovers its
balances exactly, and (because its ``--instance`` name is stable)
reclaims its own shard leases instantly instead of waiting out the TTL.

Replicas boot in parallel: every process is started first, then each
banner is read with its own deadline, so N cold CUDA contexts come up in
the time of one. A replica that dies before its banner (on a machine
without a card, for one) raises :class:`ReplicaDiedError` naming the
replica and the log its errors went to; nothing falls back to the CPU.

stdlib-only: the torch work happens inside the replicas.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import threading
import time


@dataclasses.dataclass
class ReplicaSpec:
    """How to (re)launch one replica — the whole contract is "run
    exactly this again"."""

    name: str
    argv: list[str]
    env: dict[str, str] | None = None
    cwd: str | None = None
    stderr_path: str | None = None


class ReplicaDiedError(RuntimeError):
    pass


def read_banner(proc: subprocess.Popen, name: str,
                deadline_s: float = 300.0, log: str | None = None) -> dict:
    """The serve banner: first stdout line, a JSON object with a
    ``serving`` block. Slow under a cold CUDA context — the deadline is
    generous and a dead process fails fast, naming ``log`` (where its
    errors went) when the caller knows it."""
    t0 = time.monotonic()
    while True:
        line = proc.stdout.readline()
        if line:
            line = line.strip()
            if not line:
                continue
            try:
                banner = json.loads(line)
            except json.JSONDecodeError:
                continue  # stray output before the banner
            if "serving" in banner:
                return banner
            continue
        if proc.poll() is not None:
            where = f"; see {log}" if log else ""
            raise ReplicaDiedError(
                f"replica {name} exited rc={proc.returncode} "
                f"before printing its banner{where}")
        if time.monotonic() - t0 > deadline_s:
            raise TimeoutError(
                f"replica {name}: no banner within {deadline_s}s")
        time.sleep(0.05)


class Supervisor:
    """Boot N replicas, keep them running.

    ``on_up(name, url, banner)`` fires after every (re)boot once the
    banner is read — the front end re-targets a restarted replica
    there (``--port 0`` means the port changes across restarts even
    though the argv does not). ``on_down(name, returncode)`` fires
    when a death is noticed. ``kill(name)`` is the chaos input: the
    monitor treats an operator SIGKILL exactly like any other death.
    """

    def __init__(self, specs: list[ReplicaSpec], *,
                 restart: bool = True, max_restarts: int = 5,
                 backoff_s: float = 0.25, poll_s: float = 0.1,
                 banner_deadline_s: float = 300.0,
                 on_up=None, on_down=None):
        self.specs = {s.name: s for s in specs}
        if len(self.specs) != len(specs):
            raise ValueError("replica names must be unique")
        self.restart = restart
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.poll_s = poll_s
        self.banner_deadline_s = banner_deadline_s
        self.on_up = on_up
        self.on_down = on_down
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}  # guarded by: _lock
        self._urls: dict[str, str] = {}                # guarded by: _lock
        self._banners: dict[str, dict] = {}            # guarded by: _lock
        self.restarts: dict[str, int] = {}             # guarded by: _lock
        #: every launch's argv, per replica, oldest first: a restart's
        #: entry equals the boot's (the failover contract, checkable)
        self.launched: dict[str, list[list[str]]] = {}  # guarded by: _lock
        self._stopping = threading.Event()
        self._monitor: threading.Thread | None = None

    # -- launch ------------------------------------------------------

    def _spawn(self, spec: ReplicaSpec) -> subprocess.Popen:
        env = dict(os.environ)
        if spec.env:
            env.update(spec.env)
        stderr = (open(spec.stderr_path, "ab")
                  if spec.stderr_path else subprocess.DEVNULL)
        try:
            proc = subprocess.Popen(
                spec.argv, stdout=subprocess.PIPE, stderr=stderr,
                env=env, cwd=spec.cwd, text=True)
        finally:
            if stderr is not subprocess.DEVNULL:
                stderr.close()  # the child holds its own fd now
        with self._lock:
            self.launched.setdefault(spec.name, []).append(list(spec.argv))
        return proc

    def _adopt(self, spec: ReplicaSpec, proc: subprocess.Popen) -> None:
        """Read a spawned replica's banner and publish it (``on_up``);
        a replica that dies or stays silent is killed and raises."""
        try:
            banner = read_banner(proc, spec.name, self.banner_deadline_s,
                                 log=spec.stderr_path)
        except BaseException:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=5.0)
            if proc.stdout is not None:
                proc.stdout.close()
            raise
        srv = banner.get("serving", {})
        host = srv.get("host", "127.0.0.1")
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
        url = f"http://{host}:{srv['port']}"
        with self._lock:
            self._procs[spec.name] = proc
            self._urls[spec.name] = url
            self._banners[spec.name] = banner
        if self.on_up is not None:
            self.on_up(spec.name, url, banner)

    def _boot(self, spec: ReplicaSpec) -> None:
        self._adopt(spec, self._spawn(spec))

    def start(self) -> None:
        """Boot every replica in parallel (all processes first, then each
        banner on its own thread with its own deadline), then start the
        monitor thread. If any replica fails to come up, every replica
        started here is stopped and the first failure is raised."""
        procs = {name: self._spawn(spec)
                 for name, spec in self.specs.items()}
        errors: dict[str, BaseException] = {}

        def adopt(name: str) -> None:
            try:
                self._adopt(self.specs[name], procs[name])
            except BaseException as e:  # re-raised on the caller's thread
                errors[name] = e

        threads = [threading.Thread(target=adopt, args=(name,),
                                    name=f"fleet-boot-{name}", daemon=True)
                   for name in procs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.banner_deadline_s + 5.0)
        for name, t in zip(procs, threads):
            if t.is_alive():
                # silent past its deadline: the kill ends its banner read
                procs[name].kill()
                t.join()
        if errors:
            # a failed replica killed itself in _adopt; stop the others
            self.stop()
            raise errors[sorted(errors)[0]]
        self._monitor = threading.Thread(
            target=self._watch, name="fleet-supervisor", daemon=True)
        self._monitor.start()

    # -- monitoring --------------------------------------------------

    def _watch(self) -> None:
        while not self._stopping.is_set():
            for name, spec in list(self.specs.items()):
                with self._lock:
                    proc = self._procs.get(name)
                if proc is None:
                    continue
                rc = proc.poll()
                if rc is None or self._stopping.is_set():
                    continue
                with self._lock:
                    self._procs.pop(name, None)
                    self._urls.pop(name, None)
                    n = self.restarts.get(name, 0)
                if self.on_down is not None:
                    self.on_down(name, rc)
                if not self.restart or n >= self.max_restarts:
                    continue
                time.sleep(self.backoff_s)
                try:
                    self._boot(spec)  # IDENTICAL argv: the contract
                except (ReplicaDiedError, TimeoutError, OSError):
                    continue  # next poll retries while budget lasts
                with self._lock:
                    self.restarts[name] = n + 1
            self._stopping.wait(self.poll_s)

    # -- operator surface --------------------------------------------

    def url(self, name: str) -> str:
        with self._lock:
            return self._urls[name]

    def urls(self) -> dict[str, str]:
        with self._lock:
            return dict(self._urls)

    def pid(self, name: str) -> int | None:
        with self._lock:
            proc = self._procs.get(name)
        return None if proc is None else proc.pid

    def kill(self, name: str, sig: int = signal.SIGKILL) -> int:
        """Send ``sig`` to a replica (the failover drill's SIGKILL);
        returns the pid signalled. The monitor notices the death and
        restarts per policy."""
        with self._lock:
            proc = self._procs[name]
        proc.send_signal(sig)
        return proc.pid

    def wait_restarted(self, name: str, n: int = 1,
                       timeout_s: float = 300.0) -> str:
        """Block until ``name`` has been restarted at least ``n``
        times and is back up; returns its new url."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            with self._lock:
                if (self.restarts.get(name, 0) >= n
                        and name in self._urls):
                    return self._urls[name]
            time.sleep(0.05)
        raise TimeoutError(f"replica {name} not restarted within "
                           f"{timeout_s}s")

    def stop(self, timeout_s: float = 10.0) -> None:
        """Graceful teardown: terminate, wait, escalate to kill."""
        self._stopping.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        with self._lock:
            procs = dict(self._procs)
            self._procs.clear()
            self._urls.clear()
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout_s
        for proc in procs.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
            if proc.stdout is not None:
                proc.stdout.close()
