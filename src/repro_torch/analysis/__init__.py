"""repro_torch.analysis — static control-flow verification and CFG fingerprints.

Port of ``repro.analysis`` (numpy only, copied; it imports nothing of
``repro``).

Analyze encoded SASS-lite programs *without executing them*:

>>> from repro_torch.analysis import analyze_program
>>> report = analyze_program(prog)
>>> report.ok, report.codes()
(True, ())

Layers above consume this three ways: `Simulator.run(..., verify=True)`
and `SimulationService` admission reject ``error``-level programs before
any shard burns fuel; the archive stamps each run's CFG fingerprint into
begin-event meta and the sidecar index; ``python -m repro_torch.archive similar``
ranks archived runs by :func:`fingerprint.distance` without replaying.
``python -m repro_torch.analysis`` is the standalone lint CLI.

The package also *produces* annotations, not just checks them:
:func:`synthesize_annotations` plants BSSY/BSYNC regions, allocates Bx
registers (spilling via BMOV when nesting exceeds the file), and inserts
YIELD into spin-loops; :func:`strip_annotations` is its inverse, and
:func:`estimate` prices a program statically against the
:mod:`repro_torch.timing` latencies.  ``python -m repro_torch.analysis
--fix`` and ``Simulator.run(..., synthesize=True)`` expose the synthesis
pipeline through the platform (the reference's service also through
``serve --auto-annotate``).

See the reference's docs/analysis.md for the diagnostic catalog, the synthesis passes,
and the fingerprint format.
"""
from .cfg import SINK, Loop, ProgramCFG
from .cost import CostEstimate, estimate, rank_correlation
from .fingerprint import (FEATURES, FP_VERSION, distance, fingerprint,
                          fingerprint_meta, rank)
from .passes import (AnalysisReport, Diagnostic, Severity,
                     StaticAnalysisError, analyze_program, verify_program)
from .transform import (StripResult, SynthesisResult, TransformError,
                        strip_annotations, synthesize_annotations)

__all__ = [
    "AnalysisReport", "CostEstimate", "Diagnostic", "FEATURES",
    "FP_VERSION", "Loop", "ProgramCFG", "SINK", "Severity",
    "StaticAnalysisError", "StripResult", "SynthesisResult",
    "TransformError", "analyze_program", "distance", "estimate",
    "fingerprint", "fingerprint_meta", "rank", "rank_correlation",
    "strip_annotations", "synthesize_annotations", "verify_program",
]
