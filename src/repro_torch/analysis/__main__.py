"""``python -m repro_torch.analysis [--out report.json] [--arch ARCH]
[--no-scheduler] [--device cuda|cpu]``.

Runs every analyzer over every serving entry point
(``analysis.entrypoints.run_analysis``) on the card (the default; it
raises where there is none) or on the CPU (``--device cpu``), writes the
schema-validated JSON report, prints a summary, and exits:

- 0  clean (entry points recorded, zero findings)
- 1  findings (each printed with code, entry point, location)
- 2  zero entry points analyzed: the sweep itself broke (an empty
     analysis never reads as green)
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.entrypoints import run_analysis
from repro_torch.analysis.report import TOOL, make_report, write_report
from repro_torch.launch.engine import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Contract checks over the serving engine's recorded "
                    "entry points.")
    ap.add_argument("--out", default="analysis_report.json",
                    help="path for the JSON report artifact")
    ap.add_argument("--arch", default="smollm-135m",
                    help="architecture preset to assemble (smoke shapes)")
    ap.add_argument("--no-scheduler", action="store_true",
                    help="skip the scheduler sessions' budget checks")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the sweep runs (default: the CUDA device; "
                         "raises where there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    findings, names = run_analysis(args.arch, device=device,
                                   with_scheduler=not args.no_scheduler)
    report = make_report(findings, tool=TOOL, entry_points=names,
                         backend=device.type)
    write_report(args.out, report)
    print(f"analyzed {len(names)} entry points "
          f"(backend={report['backend']}); "
          f"{report['counts']['error']} error(s), "
          f"{report['counts']['warning']} warning(s) -> {args.out}")
    for f in findings:
        where = f.entry_point or "repo"
        loc = f" [{f.location}]" if f.location else ""
        print(f"  {f.severity.upper()} {f.code} ({where}){loc}: "
              f"{f.message}")
    if not names:
        print("FATAL: zero entry points analyzed: the sweep is broken, "
              "refusing to report green", file=sys.stderr)
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
