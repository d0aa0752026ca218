"""CLI: ``python -m repro_torch.analysis [root] [--json] [--contracts]
[--no-lint] [--device cpu|cuda]``.

Exit codes: 0 clean, 1 violations found, 2 usage/setup error (a bad
argument, or ``--contracts`` on the card where there is none).

By default runs the AST lint (layer 1) over ``src/repro_torch``.
``--contracts`` adds the runtime contract checker (layer 2; imports torch,
runs the five program families at P = 1 and P = 8), on the card unless
``--device cpu``.  ``--no-lint`` skips layer 1.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _find_package_root(explicit: str | None) -> Path:
    if explicit is not None:
        root = Path(explicit)
        if not root.is_dir():
            raise SystemExit(f"error: no such directory: {root}")
        return root
    # the package we were imported from — works for PYTHONPATH=src and
    # installed layouts alike
    return Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Repo-invariant checks of the port: AST lint (R1-R5) "
                    "and runtime contract checks (C1-C4).")
    parser.add_argument("root", nargs="?", default=None,
                        help="package root to lint (default: the installed "
                             "repro_torch package directory)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit a JSON report instead of file:line lines")
    parser.add_argument("--contracts", action="store_true",
                        help="also run the runtime contract checker "
                             "(imports torch)")
    parser.add_argument("--no-lint", action="store_true",
                        help="skip the AST lint layer")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="device of the contract checks (default: the "
                             "card; there is no fallback to the CPU)")
    args = parser.parse_args(argv)

    if args.no_lint and not args.contracts:
        parser.error("--no-lint without --contracts checks nothing")

    package_root = _find_package_root(args.root)

    report = None
    if not args.no_lint:
        from repro_torch.analysis.lint import lint_paths
        report = lint_paths(package_root)

    contract_failures: list[str] = []
    contract_checked = 0
    if args.contracts:
        from repro_torch.analysis.contracts import check_all_contracts
        from repro_torch.launch.mesh import resolve_device
        try:
            device = resolve_device(args.device)
        except RuntimeError as exc:
            parser.exit(2, f"error: {exc}\n")
        contract_failures, contract_checked = check_all_contracts(
            device=device)

    ok = (report is None or report.ok) and not contract_failures

    if args.as_json:
        payload: dict = {"ok": ok}
        if report is not None:
            payload["lint"] = report.to_json()
        if args.contracts:
            payload["contracts"] = {"checked": contract_checked,
                                    "failures": contract_failures}
        print(json.dumps(payload, indent=2))
    else:
        if report is not None:
            for v in report.violations:
                print(v.render())
            print(f"lint: {report.files_checked} files, "
                  f"{len(report.violations)} violation(s), "
                  f"{len(report.waived)} waived", file=sys.stderr)
        if args.contracts:
            for f in contract_failures:
                print(f"CONTRACT {f}")
            print(f"contracts: {contract_checked} program(s) checked, "
                  f"{len(contract_failures)} failure(s)", file=sys.stderr)

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
