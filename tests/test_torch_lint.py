"""``python -m dpcorr_torch lint`` (dpcorr_torch/analysis) against
``python -m dpcorr lint`` (dpcorr/analysis).

- The framework-free families (budget, locks, metrics, rawdata and the
  deep lockorder, durability, deepbudget, coverage) give the same
  (rule, line, message) on every JAX fixture laid out at
  ``dpcorr/<area>/`` and ``dpcorr_torch/<area>/`` (imports and lock ids
  renamed).
- The torch-idiom families (sync, rng, purity, compilepath) give the
  same (rule, line) list on line-aligned twins: the JAX fixture and a
  torch source with the torch counterpart on the same line.
- The JAX package's 34 suppressions each have a counterpart with the
  same rule and reason in the mirrored port module, or a stated reason
  why the port has no such site; every port suppression gives its
  reason.
- The static lock models of the stateful modules are equal with the
  package renamed.
- The CLI: exit codes, rule ids, baseline, and ``lint`` / ``lint
  --deep`` clean on the checkout in a process that cannot import torch.
"""

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import dpcorr.analysis as jax_analysis
import dpcorr.analysis.callgraph as jax_callgraph
import dpcorr_torch.analysis as port_analysis
import dpcorr_torch.analysis.callgraph as port_callgraph
from dpcorr.analysis import core as jax_core
from dpcorr_torch.analysis import core as port_core
from dpcorr_torch.analysis.cli import DEFAULT_BASELINE
from dpcorr_torch.analysis.cli import main as lint_main

REPO = Path(__file__).parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint"

FREE_FAMILIES = ["budget", "locks", "metrics", "rawdata"]
DEEP_FAMILIES = ["lockorder", "durability", "deepbudget", "coverage"]
MODULE_FIXTURES = sorted(
    str(p.relative_to(FIXTURES)) for area in ("serve", "protocol", "stream")
    for p in (FIXTURES / area).glob("*.py")
    if not p.name.startswith("deepbudget"))
DEEP_FIXTURES = sorted(
    [str(p.relative_to(FIXTURES)) for p in (FIXTURES / "deep").glob("*.py")]
    + [f"serve/{p.name}" for p in (FIXTURES / "serve").glob("deepbudget*")])


def _lay_out(tmp_path: Path, pkg: str, fixture: str) -> tuple[Path, str]:
    """The fixture at ``<tmp>/<pkg>/<pkg>/<fixture>``, with its
    ``dpcorr.`` imports renamed for the port; returns (root, relpath)."""
    root = tmp_path / pkg
    rel = f"{pkg}/{fixture}"
    (root / rel).parent.mkdir(parents=True, exist_ok=True)
    src = (FIXTURES / fixture).read_text()
    if pkg == "dpcorr_torch":
        src = re.sub(r"\bdpcorr\.", "dpcorr_torch.", src)
    (root / rel).write_text(src)
    return root, rel


def _renamed(violations) -> list:
    return [(v.rule, v.path.replace("dpcorr_torch/", "dpcorr/"), v.line,
             v.message.replace("dpcorr_torch", "dpcorr"),
             tuple(h.replace("dpcorr_torch", "dpcorr") for h in v.chain))
            for v in violations]


def _both(tmp_path, fixture, families, deep=False):
    out = {}
    for pkg, analysis in (("dpcorr", jax_analysis),
                          ("dpcorr_torch", port_analysis)):
        root, rel = _lay_out(tmp_path, pkg, fixture)
        out[pkg] = _renamed(analysis.run_lint([rel], str(root),
                                              rule_filter=families,
                                              deep=deep))
    return out


# ------------------------------------------- framework-free families ----
@pytest.mark.parametrize("fixture", MODULE_FIXTURES)
def test_framework_free_family_matches_jax(tmp_path, fixture):
    got = _both(tmp_path, fixture, FREE_FAMILIES)
    assert got["dpcorr_torch"] == got["dpcorr"]
    assert bool(got["dpcorr"]) == fixture.endswith("_bad.py")


@pytest.mark.parametrize("fixture", DEEP_FIXTURES)
def test_deep_family_matches_jax(tmp_path, fixture):
    got = _both(tmp_path, fixture, DEEP_FAMILIES, deep=True)
    assert got["dpcorr_torch"] == got["dpcorr"]
    assert bool(got["dpcorr"]) == fixture.endswith("_bad.py")


# ---------------------------------------------- torch-idiom families ----
# Each twin is (family, a JAX fixture, a torch source with the torch
# idiom on the same line; a trailing comment names the JAX form it
# twins). The family is the one compared: the torch purity twin also
# captures outside the compile layer, on purpose.
TWINS = {
    "plan/sync_bad.py": ("sync", "benchmarks/sync_bad.py", '''\
"""sync-rule bad fixture: per-iteration host syncs in rep loops."""
import torch
import numpy as np


def drain_each(blocks):
    out = []
    for b in blocks:
        out.append(np.asarray(b))  # sync-in-loop
    return out


def wait_each(queue):
    total = 0.0
    while queue:
        x = queue.pop()
        torch.cuda.synchronize()  # jax.block_until_ready(x)
        total += 1.0
    return total


def comp_fetch(blocks):
    return [b.sum().cpu() for b in blocks]  # jax.device_get(b)


def method_sync(blocks):
    for b in blocks:
        b.item()  # b.block_until_ready()
'''),
    "plan/sync_tolist.py": ("sync", "plan/sync_bad.py", None),
    "models/rng_bad.py": ("rng", "rng_bad.py", '''\
"""Violating fixture: every rng rule fires in here."""

from dpcorr_torch.utils import rng


def two_draws(key):
    a = rng.normal(key, (3,))
    b = rng.uniform(key, (3,))  # rng-key-reuse
    return a + b


def literal_seed():
    return torch.manual_seed(42)  # jax.random.PRNGKey(42)


def raw_fold(key):
    return rng.fold_in(key, 3)  # jax.random.fold_in(key, 3)


import torch  # noqa: E402
'''),
    "purity_bad.py": ("purity", "purity_bad.py", '''\
"""Violating fixture: both purity rules fire in here."""

import time

import torch

_cache = {}


@torch.compile
def stamped(x):
    return x * time.time()  # jit-impure-call


def printy(x):
    print("tracing", x)  # captured via torch.compile below
    return x


traced = torch.compile(printy)


@torch.func.vmap
def memoized(x):
    _cache.last = x  # _cache["last"] = x
    return x


def scanned(xs, graph):
    with torch.cuda.graph(graph):
        _cache.update(last=xs)  # captured once, not per replay
        xs.add_(1.0)

    return xs
'''),
    "compilepath_bad.py": ("compilepath", "compilepath_bad.py", '''\
"""compilepath bad fixture: builds and captures outside their layers."""
import subprocess


def private_build(src, out):
    cmd = ["-arch=sm_90a", "-o", out, src]
    return subprocess.run([nvcc_path(), *cmd])  # jitted.lower().compile()


def chained_inline(fn, x):
    return torch.compile(fn)(x)  # jax.jit(fn).lower(x).compile()


def with_options(fn, x, graph):
    with torch.cuda.graph(graph):  # fn.lower(x).compile(...)
        return fn(x)


import torch  # noqa: E402
'''),
}


def _twin_sources(name: str) -> tuple[str, str]:
    _, jax_fixture, port_src = TWINS[name]
    jax_src = (FIXTURES / jax_fixture).read_text()
    if port_src is None:  # plan/sync_bad.py: only the sync calls differ
        port_src = jax_src.replace("jax.block_until_ready(r)", "r.tolist()") \
            .replace("np.asarray(o) for o", "o.numpy() for o")
        assert port_src.count("tolist") == port_src.count("numpy()") == 1
    return jax_src, port_src


def _run_source(analysis, tmp_path: Path, rel: str, src: str,
                family=None) -> list:
    (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / rel).write_text(src)
    return [(v.rule, v.line) for v in analysis.run_lint(
        [rel], str(tmp_path), rule_filter=family and [family])]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_torch_idiom_twin_fires_on_the_same_lines(tmp_path, name):
    family = TWINS[name][0]
    jax_src, port_src = _twin_sources(name)
    want = _run_source(jax_analysis, tmp_path / "j", f"dpcorr/{name}",
                       jax_src, family)
    got = _run_source(port_analysis, tmp_path / "t", f"dpcorr_torch/{name}",
                      port_src, family)
    assert want and got == want


# torch sources the port's torch-idiom families must leave alone
TORCH_CLEAN = {
    # one sync at the reduction boundary, after the loop
    "plan/one_fetch.py": '''\
import torch


def run(blocks):
    acc = torch.zeros(())
    for b in blocks:
        acc += b.sum()
    return acc.item()
''',
    # named streams and a key per draw
    "models/streams.py": '''\
from dpcorr_torch.utils import rng


def draws(key, seed):
    a = rng.normal(rng.stream(key, "a"), (3,))
    b = rng.uniform(rng.stream(key, "b"), (3,))
    return a + b, rng.master_key(seed)
''',
    # a capture in the compile layer; a tensor write inside it
    "utils/compile.py": '''\
import torch


def capture(graph, static, x):
    with torch.cuda.graph(graph):
        static[:] = x * 2.0
    return torch.compile(capture)
''',
    # the build layer's own nvcc call
    "ops/_build.py": '''\
import subprocess


def build(src, out):
    return subprocess.run([nvcc_path(), "-o", out, src])
''',
    # host syncs outside the hot-path scope
    "serve/kernels.py": '''\
def answers(outs):
    return [o.item() for o in outs]
''',
}


@pytest.mark.parametrize("name", sorted(TORCH_CLEAN))
def test_torch_idiom_clean_sources_stay_silent(tmp_path, name):
    assert _run_source(port_analysis, tmp_path, f"dpcorr_torch/{name}",
                       TORCH_CLEAN[name]) == []


def test_suppressed_twin_is_clean(tmp_path):
    _, port_src = _twin_sources("plan/sync_bad.py")
    lines = port_src.splitlines()
    for ln in (28, 23, 17, 9):
        lines[ln - 1] += "  # dpcorr-lint: ignore[sync-in-loop]"
    assert _run_source(port_analysis, tmp_path, "dpcorr_torch/plan/m.py",
                       "\n".join(lines)) == []


# ------------------------------------------------------- scopes -------
def test_scopes_name_the_port():
    from dpcorr_torch.analysis.rules.compilepath import CompilePathChecker
    from dpcorr_torch.analysis.rules.durability import _is_durable_module
    from dpcorr_torch.analysis.rules.locks import LockChecker
    from dpcorr_torch.analysis.rules.metrics import MetricsChecker
    from dpcorr_torch.analysis.rules.sync import SyncChecker

    sync = SyncChecker()
    for hot in ("dpcorr_torch/sim.py", "dpcorr_torch/grid.py",
                "dpcorr_torch/parallel/backend.py",
                "dpcorr_torch/plan/executor.py", "dpcorr_torch/perf_fused.py",
                "chip_smoke.py"):
        assert sync.applies_to(hot), hot
    for cold in ("dpcorr_torch/serve/kernels.py", "dpcorr_torch/hrs.py",
                 "dpcorr_torch/analysis/core.py"):
        assert not sync.applies_to(cold), cold
    assert LockChecker().applies_to("dpcorr_torch/chaos.py")
    assert not LockChecker().applies_to("dpcorr/chaos.py")
    metrics = MetricsChecker()
    assert not metrics.applies_to("dpcorr_torch/obs/prof.py")
    assert metrics.applies_to("dpcorr_torch/serve/server.py")
    assert not _is_durable_module("dpcorr_torch/analysis/rules/budget.py")
    assert _is_durable_module("dpcorr_torch/serve/budget_dir.py")
    assert CompilePathChecker().applies_to("dpcorr_torch/perf_fused.py")


# ------------------------------------------------------ suppressions ----
_SUPPRESS = re.compile(r"#\s*dpcorr-lint:\s*ignore\[([^\]]+)\](.*)$")

#: the JAX package's suppressions that carry no reason text, mapped to
#: the reason of their counterpart in the port, or to None with why the
#: port has no counterpart site
BARE = {
    "grid.py": [
        "the bucket's one host read, after the plan's fetch",
        "per-point fetch boundary (the local backend persists each point "
        "before the next dispatches)",
        None,  # the degraded bucket's refetch: the port's fused buckets
               # have no fallback fetch (use_fused_ni routes them first)
    ],
    "parallel/multihost.py": [
        None,  # the port's workers run grid.run_grid on their slice, so
               # their per-point fetch is grid.py's, suppressed there
    ],
}


def _suppressions(pkg: str) -> list:
    """(module path below the package, rule, reason) for every
    suppression comment outside the linter itself."""
    out = []
    for path in sorted((REPO / pkg).rglob("*.py")):
        rel = str(path.relative_to(REPO / pkg))
        if rel.startswith("analysis/"):
            continue
        for line in path.read_text().splitlines():
            m = _SUPPRESS.search(line)
            if m:
                why = m.group(2).strip().removeprefix("—").strip()
                for rule in m.group(1).split(","):
                    out.append((rel, rule.strip(), why))
    return out


def test_every_jax_suppression_has_its_port_counterpart():
    """Each JAX suppression has one in the mirrored port module with the
    same rule and the same reason (the bare ones through BARE)."""
    jax_s = _suppressions("dpcorr")
    port_s = collections.Counter(_suppressions("dpcorr_torch"))
    assert len(jax_s) == 34
    want = collections.Counter(s for s in jax_s if s[2])
    for rel, whys in BARE.items():
        assert sum(1 for s in jax_s if s[0] == rel and not s[2]) == len(whys)
        want.update((rel, "sync-in-loop", w) for w in whys if w)
    assert sum(want.values()) == 32
    assert want - port_s == collections.Counter()


def test_every_port_suppression_gives_its_reason():
    reasons = [(rel, why) for rel, _, why in _suppressions("dpcorr_torch")]
    reasons += [("chip_smoke.py", m.group(2).strip())
                for line in (REPO / "chip_smoke.py").read_text().splitlines()
                if (m := _SUPPRESS.search(line))]
    assert len(reasons) >= 34 + 28
    for rel, why in reasons:
        assert len(why) > 10, (rel, why)


# ------------------------------------------------------- lock model ----
LOCK_MODULES = ("serve/ledger.py", "serve/budget_dir.py",
                "serve/fleet/lease.py", "obs/audit.py", "chaos.py")


def _lock_model(pkg: str, core, callgraph) -> dict:
    modules = []
    for rel in LOCK_MODULES:
        path = REPO / pkg / rel
        modules.append(core.Module(str(path), f"{pkg}/{rel}",
                                   path.read_text()))
    model = callgraph.ProjectModel(modules, str(REPO)).lock_model()
    text = json.dumps({
        "locks": {lid: info["kind"] for lid, info in model["locks"].items()},
        "edges": model["edges"]}, sort_keys=True)
    return json.loads(text.replace("dpcorr_torch.", "dpcorr."))


def test_lock_models_equal_with_the_package_renamed():
    want = _lock_model("dpcorr", jax_core, jax_callgraph)
    got = _lock_model("dpcorr_torch", port_core, port_callgraph)
    assert want["locks"] and want["edges"]
    assert got == want


# -------------------------------------------------------------- CLI ----
def test_rule_ids_and_families_are_the_jax_ones():
    def ids(core):
        return {c.name: sorted(c.rules)
                for c in core.default_checkers(deep=True)}

    assert ids(port_core) == ids(jax_core)


def test_cli_exit_codes_and_reports(tmp_path, capsys):
    root = str(FIXTURES)
    assert lint_main(["--root", root, "rng_ok.py"]) == 0
    assert lint_main(["--root", root, "serve/budget_bad.py"]) == 1
    assert lint_main(["--root", root, "no_such_file.py"]) == 2
    assert lint_main(["--root", root, "--rules", "nope", "rng_ok.py"]) == 2
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("rng-key-reuse", "sync-in-loop", "jit-impure-call",
                 "aot-outside-compile-layer", "blocking-under-lock"):
        assert rule in out
    assert lint_main(["--root", root, "--json",
                      "serve/budget_bad.py"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert {v["rule"] for v in report["new"]} == {
        "budget-missing-refund", "budget-uncharged-noise"}
    assert lint_main(["--root", root, "--no-baseline", "--deep",
                      "deep/lockorder_cycle_bad.py"]) == 1


def test_cli_write_then_pass_then_strict_stale(tmp_path, capsys):
    root = str(FIXTURES)
    bl = tmp_path / "bl.json"
    assert lint_main(["--root", root, "--baseline", str(bl),
                      "--write-baseline", "serve/budget_bad.py"]) == 0
    assert lint_main(["--root", root, "--baseline", str(bl),
                      "serve/budget_bad.py"]) == 0
    capsys.readouterr()
    assert lint_main(["--root", root, "--baseline", str(bl),
                      "serve/budget_ok.py"]) == 0
    assert "stale" in capsys.readouterr().out
    assert lint_main(["--root", root, "--baseline", str(bl),
                      "--strict", "serve/budget_ok.py"]) == 1


def test_port_baseline_is_empty():
    assert port_core.load_baseline(str(REPO / DEFAULT_BASELINE)) == []


def test_lint_and_deep_lint_clean_without_torch():
    """`python -m dpcorr_torch lint` and `lint --deep` over the default
    paths in a process that cannot import torch: both exit 0, and
    nothing imported torch."""
    code = (
        "import sys; sys.modules['torch'] = None\n"
        "from dpcorr_torch.__main__ import main\n"
        "rcs = []\n"
        "for argv in (['lint'], ['lint', '--deep']):\n"
        "    try:\n"
        "        main(argv)\n"
        "    except SystemExit as e:\n"
        "        rcs.append(e.code)\n"
        "assert sys.modules['torch'] is None\n"
        "print('RCS', rcs)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    assert "RCS [0, 0]" in r.stdout, r.stdout[-1500:]
    assert r.stdout.count("0 new violations") == 2
