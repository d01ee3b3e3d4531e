"""AST lint engine of the port (a copy of the JAX package's, with the
port's rules, targets and baseline): walks source trees, applies the rules,
reconciles against the committed baseline, and gates CI.

Usage (also behind the ``repro-torch-lint`` console script)::

    python -m repro_torch.analysis           # lint src/repro_torch + the
                                             # root scripts of the port
    python -m repro_torch.analysis --check   # same, exit 1 on new findings
    python -m repro_torch.analysis --audit   # + the audits, on the card
    python -m repro_torch.analysis --audit --device cpu   # ... on the CPU
    python -m repro_torch.analysis --write-baseline  # accept findings

The baseline (``analysis/baseline.json``) ratchets: it can only record
findings that still exist; entries carry a mandatory human ``reason`` and
fixed findings make the stale entry an error, so the debt list never grows
silently and never goes stale.  Inline waivers
(``# lint: allow CODE — reason``) are for individually-sanctioned sites.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.astutil import FileContext, Violation
from repro_torch.analysis.rules import ALL_RULES

_HERE = pathlib.Path(__file__).resolve()
REPO_ROOT = _HERE.parents[3]
DEFAULT_BASELINE = _HERE.parent / "baseline.json"
DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py",
                   "profile_superstep.py")


def lint_text(text: str, relpath: str = "<memory>",
              rules: Optional[Sequence] = None) -> List[Violation]:
    """Lint one source string (the test fixtures' entry point)."""
    ctx = FileContext(relpath, text)
    out: List[Violation] = []
    for rule in (rules if rules is not None else ALL_RULES):
        for v in rule.check(ctx):
            if not ctx.waived(v.code, v.line):
                out.append(v)
    return out


def iter_py_files(targets: Iterable[pathlib.Path]):
    for t in targets:
        if t.is_file() and t.suffix == ".py":
            yield t
        elif t.is_dir():
            yield from sorted(p for p in t.rglob("*.py")
                              if "__pycache__" not in p.parts)


def lint_paths(targets: Sequence[pathlib.Path],
               rules: Optional[Sequence] = None
               ) -> Tuple[List[Violation], int]:
    """Returns (violations, n_files).  Paths render repo-relative."""
    out: List[Violation] = []
    n_files = 0
    for path in iter_py_files(targets):
        n_files += 1
        try:
            rel = path.resolve().relative_to(REPO_ROOT).as_posix()
        except ValueError:
            rel = path.as_posix()
        out.extend(lint_text(path.read_text(), rel, rules))
    out.sort(key=lambda v: (v.path, v.line, v.code))
    return out, n_files


# --- baseline ---------------------------------------------------------------


def load_baseline(path: pathlib.Path) -> dict:
    if not path.exists():
        return {"version": 1, "entries": []}
    data = json.loads(path.read_text())
    for entry in data.get("entries", []):
        if not entry.get("reason"):
            raise SystemExit(
                f"baseline entry {entry} has no `reason` — every baselined "
                "violation must say why it is allowed to stay")
    return data


def reconcile(violations: List[Violation], baseline: dict
              ) -> Tuple[List[Violation], List[Violation], List[dict]]:
    """Split into (new, baselined, stale_baseline_entries).

    An entry covers up to ``count`` findings with the same
    (code, path, scope) fingerprint.  Entries that no longer match
    anything are STALE and also fail --check: the ratchet only turns one
    way, so fixed debt must leave the ledger.
    """
    budget = {(e["code"], e["path"], e["scope"]): int(e.get("count", 1))
              for e in baseline.get("entries", [])}
    consumed = dict.fromkeys(budget, 0)
    new, old = [], []
    for v in violations:
        fp = v.fingerprint()
        if budget.get(fp, 0) > consumed.get(fp, 0):
            consumed[fp] += 1
            old.append(v)
        else:
            new.append(v)
    stale = [e for e in baseline.get("entries", [])
             if consumed[(e["code"], e["path"], e["scope"])] == 0]
    return new, old, stale


def write_baseline(path: pathlib.Path, violations: List[Violation]) -> None:
    counts: dict = {}
    for v in violations:
        counts[v.fingerprint()] = counts.get(v.fingerprint(), 0) + 1
    entries = [{"code": c, "path": p, "scope": s, "count": n,
                "reason": "TODO: justify or fix"}
               for (c, p, s), n in sorted(counts.items())]
    path.write_text(json.dumps({"version": 1, "entries": entries},
                               indent=2) + "\n")


def summary_dict(violations, new, baselined, n_files) -> dict:
    """Machine-readable roll-up (the JAX package's keys)."""
    per_code: dict = {}
    for v in violations:
        per_code[v.code] = per_code.get(v.code, 0) + 1
    return {"files_scanned": n_files,
            "rules": [r.CODE for r in ALL_RULES],
            "violations_total": len(violations),
            "violations_new": len(new),
            "violations_baselined": len(baselined),
            "by_code": per_code}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="the port's linter + its audits on the card")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_TARGETS})")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any non-baselined violation or stale "
                         "baseline entry (the CI gate)")
    ap.add_argument("--audit", action="store_true",
                    help="also run the audits (launches, kernel "
                         "resources, collectives, steady state)")
    ap.add_argument("--device", default=None,
                    help="where the audits run (default: the CUDA card, "
                         "and they raise without one; 'cpu' runs them on "
                         "the plain versions)")
    ap.add_argument("--baseline", type=pathlib.Path,
                    default=DEFAULT_BASELINE)
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as the new baseline")
    ap.add_argument("--json", type=pathlib.Path, default=None,
                    help="write the machine-readable summary here")
    ap.add_argument("--explain", metavar="CODE", default=None,
                    help="print a rule's full documentation and exit")
    args = ap.parse_args(argv)

    if args.explain:
        from repro_torch.analysis.rules import RULES_BY_CODE
        rule = RULES_BY_CODE.get(args.explain.upper())
        if rule is None:
            print(f"unknown rule {args.explain!r}; known: "
                  f"{', '.join(sorted(RULES_BY_CODE))}", file=sys.stderr)
            return 2
        print(f"{rule.CODE} — {rule.TITLE}\n\n{rule.DOC}")
        return 0

    targets = ([pathlib.Path(p) for p in args.paths] if args.paths
               else [REPO_ROOT / t for t in DEFAULT_TARGETS])
    violations, n_files = lint_paths(targets)

    if args.write_baseline:
        write_baseline(args.baseline, violations)
        print(f"baseline: recorded {len(violations)} finding(s) -> "
              f"{args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    new, baselined, stale = reconcile(violations, baseline)

    for v in new:
        print(v.render())
    if baselined:
        print(f"[baseline] {len(baselined)} known finding(s) suppressed")
    for e in stale:
        print(f"[stale-baseline] {e['code']} {e['path']} [{e['scope']}] no "
              "longer matches anything — remove the entry (ratchet!)")
    print(f"lint: {n_files} files, {len(violations)} finding(s), "
          f"{len(new)} new, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}")

    summary = summary_dict(violations, new, baselined, n_files)
    rc = 1 if (new or stale) else 0

    if args.audit:
        from repro_torch.analysis import audit as audit_mod
        results = audit_mod.run_audit(device=args.device)
        summary["audit"] = audit_mod.summary(results)
        for r in results:
            print(r.render())
        if not audit_mod.passed(results):
            rc = 1

    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=2) + "\n")

    if not args.check:
        return 0 if not args.audit else rc   # report-only unless gating
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
