"""``heat2d-tpu-torch-lint``: the port's zero-findings gate (the
counterpart of ``heat2d-tpu-lint``, ``heat2d_tpu/analysis/cli.py``).

Runs the port's rules (``analysis/lint.py``) over a checkout and exits
rc 1 on any NEW finding (one not grandfathered, with a justification, in
``analysis/baseline.json``), rc 2 on a bad baseline or rule name.
``--format json`` emits machine-readable findings; stale baseline
entries (the finding was fixed but its entry lingers) are reported, so
the baseline only ever shrinks deliberately. The JAX CLI's ``--ir`` (the
jaxpr verifier) has no counterpart yet (ROADMAP.md, A5.3b).

    heat2d-tpu-torch-lint                  # the checkout in the cwd
    heat2d-tpu-torch-lint --rules R001,R006 --format json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from heat2d_tpu_torch.analysis import lint


def _default_root() -> str:
    """The tree to lint: the cwd when it holds the package, else the
    installed package's parent (so the CLI works from anywhere)."""
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, lint.PACKAGE)):
        return cwd
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-lint",
        description="the PyTorch/CUDA port's invariant linter (rules "
                    "R001-R006)")
    p.add_argument("root", nargs="?", default=None,
                   help="tree to lint (default: the checkout in the cwd, "
                        "or the installed package's)")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset, e.g. R001,R006 "
                        "(default: all)")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON of grandfathered findings "
                        "(default: analysis/baseline.json; 'none' "
                        "disables)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--docs", default=None,
                   help="markdown file holding the port's metric tables "
                        "for the drift rule (default: <root>/README.md, "
                        f"its {lint.METRICS_HEADING!r} section)")
    args = p.parse_args(argv)

    root = args.root or _default_root()
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    baseline_path = (None if args.baseline == "none"
                     else args.baseline or default_baseline_path())
    try:
        baseline = lint.load_baseline(baseline_path)
        findings = lint.lint_tree(root, rules=rules, docs_path=args.docs)
    except (lint.BaselineError, ValueError) as e:
        print(f"heat2d-tpu-torch-lint: {e}", file=sys.stderr)
        return 2
    new, grandfathered, stale = lint.split_baselined(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "root": os.path.abspath(root),
            "rules": sorted(rules) if rules else list(lint.ALL_RULES),
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() | {"justification": baseline[f.key]}
                          for f in grandfathered],
            "stale_baseline_keys": stale,
            "ok": not new,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        if grandfathered:
            print(f"# {len(grandfathered)} baselined finding(s) "
                  "suppressed:")
            for f in grandfathered:
                print(f"#   {f.key}\n#     justification: "
                      f"{baseline[f.key]}")
        for k in stale:
            print(f"# stale baseline entry (finding no longer present): "
                  f"{k}")
        print(f"{'FAIL' if new else 'OK'}: {len(new)} new finding(s), "
              f"{len(grandfathered)} baselined, {len(stale)} stale "
              "baseline entr(y/ies)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
