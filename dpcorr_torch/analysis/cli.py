"""``python -m dpcorr_torch lint`` — the CLI over :mod:`dpcorr_torch.analysis`.

Counterpart of ``python -m dpcorr lint``, with the same flags and exit
codes: 0 clean (baselined findings included), 1 new violations (or
``--strict`` with stale baseline entries), 2 usage errors. Torch-free by
construction (stdlib ``ast`` only), so it answers in seconds and runs
where torch is not installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from dpcorr_torch.analysis import core

#: the committed grandfather file at the repo root (it holds no entry).
DEFAULT_BASELINE = ".dpcorr_torch-lint-baseline.json"
#: what `python -m dpcorr_torch lint` sweeps when no paths are given.
#: chip_smoke.py rides along for the hot-path sync rule (rules.sync): an
#: accidental per-block sync in the card's measurement harness corrupts
#: the numbers it reports.
DEFAULT_PATHS = ("dpcorr_torch", "chip_smoke.py")


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """Register the lint flags on ``ap`` (shared between the
    standalone parser and the ``python -m dpcorr_torch lint``
    subparser)."""
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/directories to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=None,
                    help="repo root paths are resolved against "
                         "(default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         f"under --root when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, grandfathered or not")
    ap.add_argument("--write-baseline", action="store_true",
                    help="triage mode: write the current findings as "
                         "the new baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated checker families to run "
                         "(rng,budget,locks,purity,rawdata,sync,"
                         "metrics; with --deep also lockorder,"
                         "durability,deepbudget,coverage; default: all)")
    ap.add_argument("--deep", action="store_true",
                    help="also run the interprocedural families over "
                         "the whole-repo call graph (lock-order "
                         "cycles, blocking-under-lock, durability, "
                         "deep budget, chaos coverage)")
    ap.add_argument("--witness", default=None, metavar="DIR",
                    help="diff runtime syncwatch witness artifacts in "
                         "DIR against the static lock model and exit "
                         "(1 on unpredicted edges, inversions or "
                         "observed cycles)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--strict", action="store_true",
                    help="also fail (exit 1) on stale baseline entries")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and description, exit 0")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dpcorr_torch lint",
        description="AST-based privacy/RNG/concurrency invariant "
                    "checker over the port's own source")
    add_arguments(ap)
    return ap


def _list_rules() -> int:
    for checker in core.default_checkers(deep=True):
        print(f"{checker.name}:")
        for rule, desc in checker.rules.items():
            print(f"  {rule:<24} {desc}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


def run(args: argparse.Namespace) -> int:
    if args.list_rules:
        return _list_rules()
    root = os.path.abspath(args.root or os.getcwd())
    paths = args.paths or list(DEFAULT_PATHS)
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(full):
            print(f"dpcorr_torch lint: no such path: {p}", file=sys.stderr)
            return 2
    rule_filter = ([s.strip() for s in args.rules.split(",") if s.strip()]
                   if args.rules else None)
    if args.witness is not None:
        from dpcorr_torch.analysis import witness

        return witness.run_witness_check(paths, root, args.witness,
                                         as_json=args.json)
    try:
        violations = core.run_lint(paths, root, rule_filter=rule_filter,
                                   deep=args.deep)
    except ValueError as e:
        print(f"dpcorr_torch lint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    if args.write_baseline:
        core.write_baseline(violations, baseline_path)
        print(f"wrote {len(violations)} baseline entries to "
              f"{baseline_path}")
        return 0

    entries: list[dict] = []
    if not args.no_baseline and os.path.exists(baseline_path):
        entries = core.load_baseline(baseline_path)
    new, matched, stale = core.apply_baseline(violations, entries)

    if args.json:
        print(json.dumps({
            "new": [vars(v) for v in new],
            "baselined": matched,
            "stale_baseline_entries": stale,
        }, indent=2))
    else:
        for v in new:
            print(v.render())
            if v.code:
                print(f"    {v.code}")
        for e in stale:
            print(f"stale baseline entry (fixed? regenerate with "
                  f"--write-baseline): [{e['rule']}] {e['path']}: "
                  f"{e['code']}")
        summary = (f"{len(new)} new violation"
                   f"{'' if len(new) == 1 else 's'}")
        if matched:
            summary += f", {matched} baselined"
        if stale:
            summary += f", {len(stale)} stale baseline entries"
        print(summary)
    if new:
        return 1
    if stale and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
