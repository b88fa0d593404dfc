"""The analysis report: one schema for every analyzer's findings.

Counterpart of ``repro/analysis/report.py``, with the same schema (version
1) and the same ``Finding`` fields, so either package's validator accepts
the other's reports.  Every checker in ``repro_torch.analysis`` emits
:class:`Finding` records; ``python -m repro_torch.analysis`` serializes
them into one JSON artifact and fails on any finding (or on an empty
entry-point set).  The schema is validated before the file is written, so
a malformed report is itself a failure.

Report schema (version 1)::

    {
      "schema_version": 1,
      "tool": "repro_torch.analysis",
      "backend": "cpu" | "cuda",
      "entry_points": ["prefill[int8,kv8]", ...],
      "n_entry_points": 27,
      "counts": {"error": 0, "warning": 0},
      "findings": [
        {"analyzer": "dtype_drift", "code": "drift.promote",
         "severity": "error", "entry_point": "prefill[int8,kv8]",
         "message": "...", "location": "repro_torch/models/layers.py:80"},
        ...
      ]
    }

``backend`` is the device type the sweep ran on.  ``validate_report`` is
pure structural checking (standard library only).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Sequence

SCHEMA_VERSION = 1
SEVERITIES = ("error", "warning")
ANALYZER_NAMES = ("dtype_drift", "budgets", "kernel_contracts", "donation")
TOOL = "repro_torch.analysis"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer verdict.  ``code`` is the stable machine-readable rule
    id (``drift.promote``, ``budget.retrace``, ...); ``message`` explains it
    with enough context to fix the violation without re-running the pass."""
    analyzer: str
    code: str
    message: str
    entry_point: str = ""      # "" for repo-level findings (sources)
    location: str = ""         # file:line, best effort
    severity: str = "error"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def make_report(findings: Iterable[Finding], *, tool: str = TOOL,
                entry_points: Sequence[str] = (),
                backend: str = "") -> dict:
    findings = list(findings)
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] += 1
    report = {
        "schema_version": SCHEMA_VERSION,
        "tool": tool,
        "backend": backend,
        "entry_points": list(entry_points),
        "n_entry_points": len(entry_points),
        "counts": counts,
        "findings": [f.to_dict() for f in findings],
    }
    errors = validate_report(report)
    if errors:  # a checker's fault, not the checked code's: fail loudly
        raise ValueError("analysis report failed its own schema: "
                         + "; ".join(errors))
    return report


def validate_report(obj) -> list[str]:
    """Structural schema check; returns [] when valid."""
    errors = []
    if not isinstance(obj, dict):
        return [f"report must be a dict, got {type(obj).__name__}"]
    if obj.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"schema_version must be {SCHEMA_VERSION}, got "
                      f"{obj.get('schema_version')!r}")
    if not isinstance(obj.get("tool"), str) or not obj.get("tool"):
        errors.append("tool must be a non-empty string")
    eps = obj.get("entry_points")
    if not isinstance(eps, list) or not all(isinstance(e, str) for e in eps):
        errors.append("entry_points must be a list of strings")
    elif obj.get("n_entry_points") != len(eps):
        errors.append("n_entry_points does not match entry_points length")
    counts = obj.get("counts")
    if (not isinstance(counts, dict)
            or set(counts) != set(SEVERITIES)
            or not all(isinstance(v, int) and v >= 0
                       for v in counts.values())):
        errors.append(f"counts must map exactly {SEVERITIES} to ints >= 0")
    findings = obj.get("findings")
    if not isinstance(findings, list):
        return errors + ["findings must be a list"]
    tally = {s: 0 for s in SEVERITIES}
    for i, f in enumerate(findings):
        if not isinstance(f, dict):
            errors.append(f"findings[{i}] must be a dict")
            continue
        for key in ("analyzer", "code", "message", "entry_point",
                    "location", "severity"):
            if not isinstance(f.get(key), str):
                errors.append(f"findings[{i}].{key} must be a string")
        if f.get("severity") not in SEVERITIES:
            errors.append(f"findings[{i}].severity must be one of "
                          f"{SEVERITIES}, got {f.get('severity')!r}")
        else:
            tally[f["severity"]] += 1
        for key in ("analyzer", "code", "message"):
            if isinstance(f.get(key), str) and not f[key]:
                errors.append(f"findings[{i}].{key} must be non-empty")
    if isinstance(counts, dict) and not errors and tally != counts:
        errors.append(f"counts {counts} do not match findings tally {tally}")
    return errors


def write_report(path: str, report: dict) -> None:
    errors = validate_report(report)
    if errors:
        raise ValueError("refusing to write invalid report: "
                         + "; ".join(errors))
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
