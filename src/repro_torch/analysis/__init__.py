"""Contract checks over the port's serving entry points.

Counterpart of ``repro/analysis``: the serving invariants the engine
accumulated (no float leaks into the bf16 stream or the int8 domain,
integer bytes on the wire, one Program per scheduler piece, the kernels'
launch and C-interface contracts, frozen serving thresholds, alias-free
caches) as machine-checked contracts, run as ``python -m
repro_torch.analysis``, which writes one schema-validated JSON report
and fails on any finding.  The port checks the contracts, not XLA's
mechanism: aten ops recorded under a ``TorchDispatchMode`` stand for
jaxprs, the ``ctypes`` C interfaces for BlockSpecs, CUDA graph captures
for XLA compiles, the recorded ``dist/collectives.py`` calls for HLO
all-reduces.

Modules:

- ``report``            Finding record + report schema (standard library)
- ``record``            the Recorder: ops, kernel calls, collectives
- ``dtype_drift``       float leaks, raw int8 casts, float collectives
- ``budgets``           Program budgets, CaptureWatch, the host-read guard
- ``kernel_contracts``  kernel launch and C-interface contracts
- ``donation``          cache aliasing + the TQT freeze contract
- ``entrypoints``       which steps make up the serving surface
"""
from repro_torch.analysis.budgets import (SCHEDULER_BUDGETS, CaptureWatch,
                                          HostReadGuard, capture_count,
                                          check_executable_budgets,
                                          check_host_reads, guarded)
from repro_torch.analysis.donation import (check_duplicate_donation,
                                           check_frozen_qparams,
                                           check_no_fake_quant)
from repro_torch.analysis.dtype_drift import (DEFAULT_ALLOWLIST, AllowRule,
                                              check_dtype_drift,
                                              check_integer_all_reduces)
from repro_torch.analysis.kernel_contracts import (check_kernel_calls,
                                                   check_kernel_sources,
                                                   check_launch_counts)
from repro_torch.analysis.record import Recorder
from repro_torch.analysis.report import (Finding, make_report,
                                         validate_report, write_report)

__all__ = [
    "AllowRule", "CaptureWatch", "DEFAULT_ALLOWLIST", "Finding",
    "HostReadGuard", "Recorder", "SCHEDULER_BUDGETS", "capture_count",
    "check_dtype_drift", "check_duplicate_donation",
    "check_executable_budgets", "check_frozen_qparams", "check_host_reads",
    "check_integer_all_reduces", "check_kernel_calls",
    "check_kernel_sources", "check_launch_counts", "check_no_fake_quant",
    "guarded", "make_report", "validate_report", "write_report",
]
