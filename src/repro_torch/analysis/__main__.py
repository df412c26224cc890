"""CLI for the port's analysis pass.

``python -m repro_torch.analysis``          lint src/repro_torch, then run the
                                            contract matrix and the launch
                                            sentinel (exit != 0 on any finding
                                            or violation).
``python -m repro_torch.analysis PATH...``  lint only the given files/dirs (no
                                            contracts: used for fixtures).
``--format json [-o FILE]``                 machine-readable report.
``--no-contracts`` / ``--only-contracts``   select a layer.
``--device cuda``                           run the contracts on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.lint import lint_paths


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="FLT lints + round contracts for the PyTorch port")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/dirs to lint (default: src/repro_torch, plus "
                             "the contract matrix and the launch sentinel)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("-o", "--output", type=Path, default=None,
                        help="write the report to FILE instead of stdout")
    parser.add_argument("--no-contracts", action="store_true",
                        help="skip the contract matrix and the launch sentinel")
    parser.add_argument("--only-contracts", action="store_true",
                        help="run only the contract matrix and the launch sentinel")
    parser.add_argument("--device", default="cpu",
                        help="the contracts' device (default cpu)")
    parser.add_argument("--root", type=Path, default=None,
                        help="repo root (default: discovered from paths)")
    args = parser.parse_args(argv)

    explicit_paths = bool(args.paths)
    root = args.root or Path(__file__).resolve().parents[3]
    paths = args.paths or [root / "src" / "repro_torch"]

    report: dict = {"tool": "repro_torch.analysis", "lint": None,
                    "contracts": None, "launches": None}
    exit_code = 0

    if not args.only_contracts:
        result = lint_paths(paths, root=root)
        report["lint"] = json.loads(result.to_json())
        exit_code = max(exit_code, result.exit_code)
        if args.format == "text":
            _emit(result.render_text(), args.output, append=False)

    if args.only_contracts or (not explicit_paths and not args.no_contracts):
        from repro_torch.analysis import contracts, launches

        contract_report = contracts.run_matrix(device=args.device)
        sentinel = launches.run(device=args.device)
        bad = [v for _, _, vs in sentinel for v in vs]
        report["contracts"] = contract_report.to_dict()
        report["launches"] = {"runs": [n for n, _, _ in sentinel], "ok": not bad,
                              "violations": [v.render() for v in bad]}
        exit_code = max(exit_code, 0 if contract_report.ok and not bad else 1)
        if args.format == "text":
            _emit(contract_report.render_text(), args.output, append=True)
            _emit("\n".join([v.render() for v in bad] + [
                f"launches: {len(sentinel)} run(s), {len(bad)} violation(s)"]),
                args.output, append=True)

    if args.format == "json":
        _emit(json.dumps(report, indent=2), args.output, append=False)
    return exit_code


def _emit(text: str, output: Path | None, append: bool) -> None:
    if output is None:
        print(text)
    else:
        mode = "a" if append and output.exists() else "w"
        with open(output, mode) as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())
