"""Finding/report plumbing shared by the three analyzer layers.

The port's copy of ``repro/analysis/report.py``: every check emits
``Finding`` records keyed by a stable rule ID; the ``Report`` collects
them, applies per-rule suppression, and serializes to the JSON report.
The rule IDs and severities are the reference's where the contract is
the same; the descriptions name the torch analogs.  Severity
semantics:

* ``error``   — a contract violation; fails the run (exit 1).
* ``warning`` — a diagnostic (e.g. a tile that falls back to a slower
  body); fails the run only under ``--strict``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

# rule id -> (severity, one-line contract description)
RULES: Dict[str, tuple] = {
    # layer 1: the serving work units, run under a dispatch mode (and
    # captured into CUDA graphs on the card)
    "JX001": ("error", "host synchronization on the serving hot path "
                       "(a scalar read or a copy to the host inside a "
                       "work unit's body, a sync under sync debug mode, "
                       "or a capture that failed)"),
    "JX002": ("error", "data-dependent output shape in a work unit's body "
                       "(nonzero, masked_select, unique, a boolean-mask "
                       "index, repeat_interleave without output_size)"),
    "JX003": ("error", "KV cache not updated in place by a work unit (its "
                       "storage moved across a call, or a call left it "
                       "unwritten)"),
    "JX004": ("error", "cross-shard grouped reduction does not "
                       "accumulate in fp32 (a gathered xshard_* partial "
                       "of another dtype; the tp-vs-1 parity contract)"),
    "JX005": ("error", "signature drift between flag combos sharing a "
                       "cache layout, or a unit that ran without one "
                       "operand signature and, on the card, exactly one "
                       "capture"),
    "JX006": ("error", "work unit ran without the serving forward's hooks "
                       "(no serving_hot_path mark, or no paged kernel "
                       "launch on the paged pool)"),
    # layer 2: launch plans of the CUDA kernels' wrappers
    "KL001": ("error", "tile larger than its operand extent"),
    "KL002": ("error", "launch grid x tile does not cover the output "
                       "(rows or context would be silently skipped)"),
    "KL003": ("warning", "tile off the warpgroup grid of its dtype: the "
                         "product falls back from wgmma to mma.sync"),
    "KL004": ("warning", "tile neither a multiple of the mma.sync "
                         "fragment nor the full operand dim"),
    "KL005": ("error", "dynamic shared memory of a block exceeds the "
                       "per-block limit"),
    # layer 3: AST rules over runtime/ + models/ + obs/
    "AST001": ("error", "host transfer (.item()/.cpu()/.tolist()/"
                        ".numpy()/synchronize/np.asarray/...) or host "
                        "RNG inside a hot-path body"),
    "AST002": ("error", "matmul/@/einsum/linear in a parity-critical "
                        "attention body that must stay explicit "
                        "multiply+sum"),
    "AST003": ("error", "mutable server state read inside a work unit's "
                        "body (a CUDA graph freezes it at capture: the "
                        "seed SlotServer frozen-self.pos bug class)"),
}


@dataclasses.dataclass
class Finding:
    rule: str
    message: str
    path: str = ""
    line: int = 0
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def severity(self) -> str:
        return RULES[self.rule][0]

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "path": self.path,
                "line": self.line, "detail": self.detail}

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}: " if self.path else ""
        return f"{loc}{self.rule} [{self.severity}] {self.message}"


class Report:
    """Collects findings across layers; applies per-rule suppression."""

    def __init__(self, suppress: Optional[List[str]] = None):
        unknown = set(suppress or ()) - set(RULES)
        if unknown:
            raise ValueError(f"unknown rule id(s) in --suppress: "
                             f"{sorted(unknown)}")
        self.suppress = set(suppress or ())
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self.extras: Dict[str, Any] = {}

    def add(self, finding: Finding) -> None:
        if finding.rule not in RULES:
            raise ValueError(f"unknown rule id {finding.rule!r}")
        if finding.rule in self.suppress:
            self.suppressed.append(finding)
        else:
            self.findings.append(finding)

    def count(self, rule: str) -> int:
        return sum(1 for f in self.findings if f.rule == rule)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def exit_code(self, strict: bool = False) -> int:
        if self.errors():
            return 1
        if strict and self.findings:
            return 1
        return 0

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self, *, strict: bool = False) -> str:
        return json.dumps({
            "strict": strict,
            "exit_code": self.exit_code(strict),
            "summary": self.summary(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            **self.extras,
        }, indent=2, sort_keys=False)
