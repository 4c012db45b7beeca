"""Serving-contract analyzer of the port (``python -m repro_torch.analysis``).

The counterpart of ``repro/analysis``: three layers, one report, the
reference's rule IDs where the contract is the same.

* ``graph_check`` — serves a tiny ``ChunkedServer`` under every flag
  combo and records each work unit's body under a dispatch mode (on the
  card also its CUDA graph: one capture, replays under sync debug
  mode): no host synchronization, no data-dependent shapes, the KV
  cache updated in place, float32 cross-shard reductions, no signature
  drift between combos, the serving forward's hooks present
  (JX001-006); with ``--spread N`` also the tensor-parallel combos, on
  a mesh of positions laid on one device.
* ``kernel_lint`` — plans every launch of the CUDA kernels' wrappers over
  the reference's workload sweep from their own tile, body and plan
  rules (on the card also runs them and matches each planned launch to
  a real one): tiles within their operands, grids covering the output,
  tiles on the warpgroup and mma.sync grids, shared memory within a
  block's (KL001-005).
* ``ast_lint`` — AST rules over ``runtime/``, ``models/`` and ``obs/``:
  host transfers and host RNG in work-unit bodies, products in the
  parity-critical attention bodies, mutable server state read by a
  body a CUDA graph captures (AST001-003).

The rule table is in README.md.
"""

from repro_torch.analysis.report import Finding, Report, RULES  # noqa: F401
