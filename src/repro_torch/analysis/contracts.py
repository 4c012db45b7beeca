"""The port's serving contracts, in one registry the analyzer layers
share (the counterpart of ``repro/analysis/contracts.py``).  Adding a
work-unit body, a parity-critical body or a flag combo here is how the
gate learns about new code paths — the checks themselves stay generic.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# ----------------------------------------------------------------------
# trace hooks (models/common.mark: a named op the dispatch mode sees)
# ----------------------------------------------------------------------

# the serving forward marks its final hidden state; a work unit whose
# recorded ops lack it did not go through models/transformer's
# _serving_scan (JX006)
SERVING_TAG = "serving_hot_path"

# the grouped cross-shard reductions mark their gathered partials with
# a tag of this prefix (models/common.fixed_tree_sum, `xshard_sum`):
# JX004 holds every such tensor to float32
XSHARD_TAG_PREFIX = "xshard_"

# ----------------------------------------------------------------------
# layer 3 (AST) scope
# ----------------------------------------------------------------------

# work-unit bodies (runtime/graphs.WorkUnit: one CUDA graph each on the
# card): (module, Class.method).  ast_lint builds a static call graph
# from these across the scanned modules and applies AST001 to
# everything reachable.
HOT_PATH_ROOTS = [
    ("repro_torch.runtime.server", "ChunkedServer._chunk_body"),
    ("repro_torch.runtime.server", "ChunkedServer._span_body"),
    ("repro_torch.runtime.server", "ChunkedServer._spec_body"),
    ("repro_torch.runtime.server", "ChunkedServer._cow_body"),
    ("repro_torch.runtime.server", "SlotServer._decode_body"),
    ("repro_torch.runtime.server", "SlotServer._prefill_body"),
]

# attention score/PV bodies that must stay explicit multiply+sum (the
# reference's bitwise kernel-vs-gather contract: a product routine may
# reorder or strength-reduce small contractions by shape, so a
# matmul/einsum formulation drifts ~1 ulp from the paged kernels'
# plain versions).  path suffix (repo-relative) -> function names.
PARITY_BODIES = {
    "models/attention.py": {"decode_attention", "chunk_attention",
                            "_masked_softmax_pv"},
    "kernels/paged_attention.py": {"paged_decode_plain", "paged_chunk_plain",
                                   "paged_decode_fp8_plain",
                                   "paged_chunk_fp8_plain"},
}

# packages scanned by ast_lint (plus the PARITY_BODIES files);
# src/repro_torch/obs is included so instrumentation helpers stay
# visible to the hot-path reachability scan — the telemetry layer must
# never put a host transfer inside a work unit's body
AST_SCAN_PACKAGES = ["src/repro_torch/runtime", "src/repro_torch/models",
                     "src/repro_torch/obs"]

# ----------------------------------------------------------------------
# layer 2 (launch plans) budgets
# ----------------------------------------------------------------------

# dynamic shared memory one block may use on the H100 (the VMEM budget's
# place); every kernel source refuses a plan past it
SMEM_LIMIT = 232448

# ----------------------------------------------------------------------
# layer 1 (work units) serving flag matrix
# ----------------------------------------------------------------------


def serving_combos(max_combos: Optional[int] = None,
                   device_count: int = 1) -> List[Dict[str, Any]]:
    """Valid ChunkedServer flag combos: the reference's single-device
    matrix with its ``kernel`` flag folded away, because the port's
    paged server always reads the pool through the CUDA kernels
    (``kernel`` is implied by ``paged``).  Combos that become equal
    merge into the first of them:

    * ``{"kernel": True}`` into ``{}``;
    * ``{"kernel": True, "spec_decode": 3}`` into ``{"spec_decode": 3}``;
    * ``{"fp8_kv": True, "kernel": True}`` into ``{"fp8_kv": True}``;

    and ``{"fp8_kv": True, "kernel": True, "spec_decode": 3}`` and
    ``{"fp8_linear": True, "fp8_kv": True, "kernel": True}`` keep their
    place without the flag: 13 combos of the reference's 16.  With
    ``device_count >= 2`` (the mesh positions the caller gives: the
    graph layer lays them on one device, a spread mesh) the reference's
    four tensor-parallel combos follow, folded the same way into three:
    ``{"tp": 2, "kernel": True}`` into ``{"tp": 2}``, and
    ``{"tp": 2, "fp8_kv": True, "kernel": True}`` keeps its place as
    ``{"tp": 2, "fp8_kv": True}``."""
    from repro_torch.models.sampling import SamplingParams
    sampled = SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                             seed=7)
    combos: List[Dict[str, Any]] = [
        {},                                         # paged + prefix (defaults)
        {"prefix_cache": False},
        {"paged": False, "prefix_cache": False},
        {"spec_decode": 3},
        {"paged": False, "prefix_cache": False, "spec_decode": 3},
        {"eos_id": 5},
        {"spec_decode": 3, "eos_id": 5},
        {"fp8_kv": True},
        {"fp8_kv": True, "spec_decode": 3},
        {"fp8_linear": True},
        {"fp8_linear": True, "fp8_kv": True},
        # stochastic sampling: greedy<->sampled must share one signature
        # per unit (sampling operands are always present; the flip is in
        # the VALUES) — JX005 proves no recapture, and JX001 that the
        # device-side threefry draw puts no host read into the span
        {"sampling": sampled},
        {"sampling": sampled, "spec_decode": 3},
    ]
    if device_count >= 2:
        combos += [
            {"tp": 2},
            {"tp": 2, "spec_decode": 3},
            {"tp": 2, "fp8_kv": True},
        ]
    if max_combos is not None:
        combos = combos[:max_combos]
    return combos


def combo_label(combo: Dict[str, Any]) -> str:
    base = {"paged": True, "prefix_cache": True, "spec_decode": 0,
            "fp8_kv": False, "fp8_linear": False, "tp": 1,
            "eos_id": None, "sampling": None}
    base.update(combo)
    parts = []
    for k, v in base.items():
        if isinstance(v, bool):
            parts.append(f"{k}={int(v)}")
        else:
            parts.append(f"{k}={v}")
    return ",".join(parts)


def signature_class(combo: Dict[str, Any]) -> str:
    """Combos agreeing on this key MUST produce identical signatures per
    work unit (JX005): only the cache layout (paged) and its dtype
    (fp8_kv) may change operand shapes/dtypes.  A tensor-parallel
    combo is in its tp=1 class: its cache enters the signature at its
    logical shape, the positions' pools joined along the KV heads, as a
    sharded array's abstract shape in the reference."""
    return (f"paged={int(combo.get('paged', True))},"
            f"fp8_kv={int(combo.get('fp8_kv', False))}")
