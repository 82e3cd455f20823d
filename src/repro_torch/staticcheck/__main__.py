"""CLI: ``python -m repro_torch.staticcheck [--rule NAME] [--list-rules]
[paths...]``.

Prints one ``path:line:col: [rule] message`` line per finding.  Exit
codes: 0 = no findings, 1 = findings, 2 = bad invocation.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.staticcheck import ALL_RULES, RULES_BY_NAME, check_paths

DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description="repro-torch-check: the port's contract checker")
    parser.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                        help="files or directories to check (default: "
                             + " ".join(DEFAULT_PATHS) + ")")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="NAME",
                        help="run only the named rule(s)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        width = max(len(r.name) for r in ALL_RULES)
        for r in ALL_RULES:
            print(f"{r.name:<{width}}  {r.description}")
        return 0

    rules = None
    if args.rule:
        unknown = [n for n in args.rule if n not in RULES_BY_NAME]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
        rules = [RULES_BY_NAME[n] for n in args.rule]

    missing = [p for p in args.paths if not pathlib.Path(p).exists()]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2

    result = check_paths(args.paths, rules=rules)
    for f in result.findings:
        print(f.format())
    n = len(result.findings)
    print(f"repro-torch-check: {n} finding{'s' if n != 1 else ''} in "
          f"{result.n_files} files", file=sys.stderr)
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
