"""Layer 1: the serving work units, run, recorded and checked.

The counterpart of ``repro/analysis/jaxpr_check.py``.  The reference
traces its jitted serving programs and walks their jaxprs; the port's
programs are the server's work units (``runtime/graphs.WorkUnit``: one
CUDA graph each on the card), so this layer serves requests through a
tiny ``ChunkedServer`` (reduced yi-6b, ``batch_slots=2, max_len=64,
chunk=8, span=4, block_size=8``, the reference's) per flag combo of
``contracts.serving_combos`` and watches every unit while it runs: each
call of a body runs under a ``TorchDispatchMode`` that records its aten
ops (on the card these are the eager first call and the captured
second; replays run no Python).

The traffic: two waves through the scheduler's own admission,
dispatch and harvest (``_admit``, ``_run_chunk_step``,
``_run_decode_span`` / ``_run_spec_step``, ``_harvest``); with spec
decode the decode stretches alternate span and verify dispatches, so
both units run.  The second wave shares 14 tokens of a first-wave
prompt, so the prefix cache copies a shared block on write.  Where a
combo's scheduler never dispatches a unit it builds (``cow_copy``
without the prefix cache), the unit is called directly with its
dispatch site's operands (a block copy between two pool blocks).  Every
unit runs at least three times.

Rules:

* **JX001** — a host synchronization inside a body: an
  ``_local_scalar_dense`` (``.item()``, ``int()`` or ``bool()`` of a
  tensor) or an op that copies a CUDA tensor to the host; on the card
  also any synchronization under ``torch.cuda.set_sync_debug_mode
  ("error")``, which wraps each body as it runs (eager and captured)
  and each replay (not the scheduler's reads after a dispatch), and a
  capture that fails.
* **JX002** — an op whose output shape depends on the data: nonzero,
  masked_select, unique, indexing or index_put with a boolean mask,
  repeat_interleave without ``output_size``.
* **JX003** — the KV cache not updated in place: a cache leaf's (or the
  server's device state's) storage moved across a call, or a call of a
  unit left a cache leaf unwritten (no op of the body wrote its
  storage; on the card, a replay left its bytes as they were).
* **JX004** — a cross-shard reduction that does not sum float32: a
  tensor marked with a ``contracts.XSHARD_TAG_PREFIX`` tag (the
  gathered partials `models/common.fixed_tree_sum` sums, at any tp) of
  another dtype.
* **JX005** — signature drift: combos of one ``signature_class`` must
  present identical operand, output and cache signatures (shapes and
  dtypes) per unit, so a flag flip (greedy/sampled included) never
  needs another program; and every unit that ran is one program
  (``programs == 1``) and, on the card, one capture (``captures ==
  1``).  ``programs`` can only be 0 or 1 (``WorkUnit._stage`` raises on
  a second signature), so that half checks that the unit ran;
  ``captures`` counts each capture, so it also catches a recapture.
* **JX006** — a forward unit's call without the serving forward's hook
  (``models/common.mark`` named ``contracts.SERVING_TAG``, set by
  ``_serving_scan``), or, on the card with the paged pool, a forward
  unit whose captured graph launches none of its paged kernel (B1/B3
  for the decode span, B2/B4 for the chunk and verify steps).

With ``spread=N`` (N >= 2) the reference's tensor-parallel combos join
the matrix (``contracts.serving_combos(device_count=N)``), each served
on a mesh of two positions laid on the one device
(``launch/mesh.make_tp_mesh(2, spread=device)``): one graph a unit
across both shards, both positions' pools written in place.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import contracts
from repro_torch.analysis.report import Finding, Report
from repro_torch.models.common import resolve_device

# ops whose output shape depends on the data (by overload packet)
_DYNAMIC_OPS = {"nonzero", "masked_select", "_unique", "_unique2",
                "unique_dim", "unique_consecutive", "unique_dim_consecutive",
                "argwhere", "nonzero_numpy"}
# units that run the serving forward (and its paged kernels)
FORWARD_UNITS = {"chunk_step": "chunk", "decode_span": "decode",
                 "verify_step": "chunk"}
# calls every unit must take
MIN_CALLS = 3


def _tensors(x):
    """The tensors in an op's arguments (flat, lists and dicts opened)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


# op -> (position, name) of the arguments it writes (its schema's
# mutable aliases), cached per overload
_WRITES: Dict[Any, Tuple[Tuple[int, str], ...]] = {}


def _writes(func) -> Tuple[Tuple[int, str], ...]:
    w = _WRITES.get(func)
    if w is None:
        w = _WRITES[func] = tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    return w


class _Recorder(TorchDispatchMode):
    """Records one body call: host syncs, data-dependent shapes, marks,
    and which watched storages were written in place."""

    def __init__(self, watched: Dict[int, str], cuda: bool):
        super().__init__()
        self.watched = watched          # storage pointer -> leaf name
        self.cuda = cuda
        self.host: List[str] = []
        self.dynamic: List[str] = []
        self.marks: List[str] = []
        self.tagged: List[Tuple[str, str]] = []     # (tag, dtype)
        self.written: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name == "mark" and func.namespace == "repro_torch":
            tag = args[1] if len(args) > 1 else kwargs["name"]
            self.marks.append(tag)
            self.tagged.append((tag, str(args[0].dtype).replace("torch.",
                                                                "")))
            return out
        if name == "_local_scalar_dense":
            self.host.append(str(func))
        elif self.cuda and any(t.device.type == "cpu"
                               for t in _tensors(out)) \
                and any(t.device.type != "cpu"
                        for t in _tensors((args, kwargs))):
            self.host.append(f"{func} (a copy to the host)")
        if name in _DYNAMIC_OPS:
            self.dynamic.append(str(func))
        elif name in ("index", "index_put", "index_put_", "_index_put_impl_") \
                and any(t.dtype == torch.bool for t in _tensors(args[1])):
            self.dynamic.append(f"{func} (boolean mask)")
        elif name == "repeat_interleave" \
                and isinstance(args[0 if len(args) == 1 else 1],
                               torch.Tensor) \
                and kwargs.get("output_size") is None:
            self.dynamic.append(f"{func} (no output_size)")
        for i, arg in _writes(func):
            t = args[i] if i < len(args) else kwargs.get(arg)
            if isinstance(t, torch.Tensor):
                leaf = self.watched.get(t.untyped_storage().data_ptr())
                if leaf is not None:
                    self.written.add(leaf)
        return out


@contextlib.contextmanager
def _sync_debug(on: bool):
    """``set_sync_debug_mode("error")`` while the block runs (CUDA only)."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _caches(srv) -> List[Dict[str, torch.Tensor]]:
    """The server's cache: one dict, or one a mesh position (tp)."""
    return srv.cache if isinstance(srv.cache, list) else [srv.cache]


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (NaN payloads and e4m3 codes included)."""
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


class UnitWatch:
    """Wraps every work unit of a server: its body under a `_Recorder`
    (and sync debug mode on the card), its calls checked for storage
    moves and, on the card, its replays for writes.  Findings go to
    `report` as they happen."""

    def __init__(self, srv, label: str, report: Report):
        self.srv, self.label, self.report = srv, label, report
        self.cuda = srv.device.type == "cuda"
        self.calls: Dict[str, int] = {}
        self.failed = False
        for name, unit in srv._units.items():
            self._wrap(name, unit)

    # -- watched tensors ----------------------------------------------------
    def _state(self) -> Dict[str, torch.Tensor]:
        srv = self.srv
        from repro_torch.runtime.server import cache_leaves
        out = {f"cache.{k}": v for k, v in cache_leaves(srv.cache).items()}
        out["cur_tok"], out["out_buf"] = srv.cur_tok, srv.out_buf
        if srv.spec_decode:
            out["ngram_table"] = srv.ngram_table
        return out

    def _add(self, rule: str, unit: str, msg: str, **detail) -> None:
        self.report.add(Finding(
            rule, f"{unit} [{self.label}]: {msg}",
            detail={"program": unit, "combo": self.label, **detail}))

    def _wrap(self, name: str, unit) -> None:
        body, run = unit._body, unit.run

        def recorded(*ops):
            state = self._state()
            rec = _Recorder({_ptr(t): k for k, t in state.items()},
                            self.cuda)
            with _sync_debug(self.cuda), rec:
                outs = body(*ops)
            self._check_call(name, rec, state)
            return outs

        def watched(*operands):
            replay = unit.graph is not None
            before = {k: (_ptr(t), t.clone() if replay else None)
                      for k, t in self._state().items()}
            try:
                with _sync_debug(self.cuda and replay):
                    outs = run(*operands)
            except RuntimeError as e:
                self.failed = True
                self._add("JX001", name, f"the call failed: {e}",
                          error=str(e)[:500])
                raise
            self.calls[name] = self.calls.get(name, 0) + 1
            after = self._state()
            for k, (ptr, snap) in before.items():
                if _ptr(after[k]) != ptr:
                    self._add("JX003", name, f"{k} moved to new storage "
                              "across a call (not updated in place)",
                              leaf=k)
                elif replay and k.startswith("cache.") \
                        and _same_bytes(after[k], snap):
                    self._add("JX003", name, f"a replay left {k} "
                              "unwritten", leaf=k)
            return outs

        unit._body = recorded
        unit.run = watched

    def _check_call(self, name: str, rec: _Recorder,
                    state: Dict[str, torch.Tensor]) -> None:
        for h in rec.host:
            self._add("JX001", name, f"host synchronization `{h}` inside "
                      "the body", op=h)
        for d in rec.dynamic:
            self._add("JX002", name, f"data-dependent output shape from "
                      f"`{d}`", op=d)
        for tag, dtype in rec.tagged:
            if tag.startswith(contracts.XSHARD_TAG_PREFIX) \
                    and dtype != "float32":
                self._add("JX004", name, f"cross-shard reduction tag "
                          f"`{tag}` accumulates in {dtype}, not float32",
                          tag=tag, dtype=dtype)
        for k in state:
            if k.startswith("cache.") and k not in rec.written:
                self._add("JX003", name, f"the call wrote nothing into {k}",
                          leaf=k)
        if name in FORWARD_UNITS and contracts.SERVING_TAG not in rec.marks:
            self._add("JX006", name, f"`{contracts.SERVING_TAG}` mark "
                      "missing — the body did not go through the serving "
                      "forward", missing=contracts.SERVING_TAG)


# ----------------------------------------------------------------------
# server construction / traffic
# ----------------------------------------------------------------------

def tiny_setup(device):
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device=device, dtype=torch.bfloat16)
    return cfg, params


def build_server(cfg, params, combo: Dict[str, Any], device):
    """The tiny server of a combo; a tp combo's mesh spreads its
    positions over `device`."""
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.runtime.server import ChunkedServer
    kw = dict(batch_slots=2, max_len=64, chunk=8, span=4, block_size=8)
    kw.update(combo)
    tp = kw.pop("tp", 1)
    if tp > 1:
        return ChunkedServer(cfg, params, mesh=make_tp_mesh(tp,
                                                            spread=device),
                             **kw)
    return ChunkedServer(cfg, params, device=device, **kw)


def waves(vocab: int, seed: int = 0) -> List[list]:
    """Two waves: two requests, then three whose prompts share the first
    14 tokens of the first one (a full block and 6 of the next: a
    copy-on-write of the shared block)."""
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    # tokens past the EOS id of the eos combo, so prompts never hold it
    tok = lambda n: rng.integers(16, vocab, n).astype(np.int32)
    base = tok(20)
    first = [Request(0, base, 12), Request(1, tok(13), 12)]
    second = [Request(2 + i, np.concatenate([base[:14], tok(3 + i)]), 12)
              for i in range(3)]
    return [first, second]


def _serve(srv, reqs) -> None:
    """One wave through the scheduler's own dispatches; spec decode
    alternates span and verify dispatches over the decode stretches."""
    srv._reset_run_counters()
    queue, turn = list(reqs), 0
    while queue or any(r is not None for r in srv.slot_req):
        srv._admit(queue)
        if any(m == "prefill" for m in srv.mode):
            srv._run_chunk_step()
        elif any(m == "decode" for m in srv.mode):
            if srv.spec_decode and turn % 2:
                srv._run_spec_step()
            else:
                srv._run_decode_span()
            turn += 1
        srv._harvest()


def _direct_cow(srv, watch: UnitWatch) -> None:
    """Copy-on-write calls where the scheduler made too few: pool block
    pairs whose contents differ (a copy of a block onto its own bytes
    writes nothing a replay can see)."""
    k = _caches(srv)[0]["k"]
    blocks = range(k.shape[1])
    while watch.calls.get("cow_copy", 0) < MIN_CALLS:
        pair = next(((a, b) for a in blocks for b in blocks
                     if not _same_bytes(k[:, a], k[:, b])), None)
        if pair is None:
            raise RuntimeError("no two pool blocks differ for a copy")
        srv._units["cow_copy"].run(np.array([pair[0]], np.int64),
                                   np.array([pair[1]], np.int64))


# ----------------------------------------------------------------------
# signatures (JX005)
# ----------------------------------------------------------------------

def unit_signature(srv, unit) -> list:
    """A unit's program signature: its operands, its outputs and the
    cache it updates, as (name, shape, dtype) entries."""
    entries = [[f"operand[{i}]", list(shape), dt]
               for i, (shape, dt) in enumerate(unit._signature or ())]
    entries += [[f"output[{i}]", list(o.shape), str(o.dtype)]
                for i, o in enumerate(unit._outputs or ())]
    caches = _caches(srv)
    for k, v in caches[0].items():
        # the logical shape: the positions' KV heads joined (dim 3)
        shape = list(v.shape)
        shape[3] = sum(c[k].shape[3] for c in caches)
        entries.append([f"cache.{k}", shape, str(v.dtype)])
    return entries


def register_signature(registry: Dict[str, Dict[str, Dict[str, Any]]],
                       program: str, sig_class: str, label: str,
                       entries: list, report: Report) -> None:
    """Record a unit's signature; JX005 on drift within its signature
    class."""
    digest = hashlib.sha256(
        json.dumps(entries, sort_keys=True).encode()).hexdigest()[:16]
    slot = registry.setdefault(program, {}).setdefault(
        sig_class, {"hash": digest, "combos": [],
                    "n_entries": len(entries)})
    if slot["hash"] != digest:
        report.add(Finding(
            "JX005",
            f"{program} [{label}]: signature {digest} drifts from "
            f"{slot['hash']} ({slot['combos'][0]}) within signature "
            f"class `{sig_class}` — flag switches would need another "
            f"program",
            detail={"program": program, "combo": label,
                    "class": sig_class, "hash": digest,
                    "expected": slot["hash"]}))
    else:
        slot["combos"].append(label)


def check_programs(srv, label: str, report: Report) -> List[dict]:
    """JX005 on each unit's program and capture counts; JX006 on the
    paged kernels a forward unit's graph launches (card, paged pool)."""
    cuda = srv.device.type == "cuda"
    rows = []
    for name, unit in srv._units.items():
        row = {"combo": label, "unit": name, "calls": unit.calls,
               "programs": unit.programs, "captures": unit.captures}
        rows.append(row)
        if unit.programs != 1 or (cuda and unit.captures != 1):
            report.add(Finding(
                "JX005",
                f"{name} [{label}]: {unit.programs} program(s), "
                f"{unit.captures} capture(s) after {unit.calls} calls "
                f"(one each expected)",
                detail={"program": name, "combo": label, **row}))
        kind = FORWARD_UNITS.get(name)
        if cuda and srv.paged and kind is not None:
            kernel = f"paged_{kind}" + ("_fp8" if srv.fp8_kv else "")
            n = unit.replay_launches.get(kernel, (0, {}))[0]
            row["paged_launches"] = {kernel: n}
            if n <= 0:
                report.add(Finding(
                    "JX006",
                    f"{name} [{label}]: its graph launches no {kernel} "
                    f"(the paged pool read without its kernel)",
                    detail={"program": name, "combo": label,
                            "kernel": kernel}))
    return rows


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

def run(report: Report, *, device=None, max_combos: Optional[int] = None,
        combos: Optional[List[Dict[str, Any]]] = None,
        spread: int = 0) -> None:
    """Serve every combo on `device` (default the CUDA device; without
    one, and without `device="cpu"`, it raises) and check its work
    units; ``spread >= 2`` adds the tensor-parallel combos on a spread
    mesh (module docstring)."""
    device = resolve_device(device)
    cfg, params = tiny_setup(device)
    if combos is None:
        combos = contracts.serving_combos(max_combos, device_count=spread)
    registry: Dict[str, Dict[str, Dict[str, Any]]] = {}
    units: List[dict] = []
    threads = torch.get_num_threads()
    if device.type == "cpu":
        # the tiny server's ops gain nothing from intra-op threads, and
        # on a busy host waking them costs 5x the layer's time
        torch.set_num_threads(1)
    try:
        _run_combos(report, cfg, params, combos, device, registry, units)
    finally:
        torch.set_num_threads(threads)
    report.extras["signatures"] = registry
    report.extras["combos"] = [contracts.combo_label(c) for c in combos]
    report.extras["graph_units"] = units


def _run_combos(report, cfg, params, combos, device, registry,
                units) -> None:
    with torch.no_grad():
        for combo in combos:
            label = contracts.combo_label(combo)
            srv = build_server(cfg, params, combo, device)
            watch = UnitWatch(srv, label, report)
            try:
                for wave in waves(cfg.vocab_size):
                    _serve(srv, wave)
                if "cow_copy" in srv._units:
                    _direct_cow(srv, watch)
            except RuntimeError:
                if watch.failed:
                    continue        # reported as JX001 by the watch
                raise
            short = {n: c for n, c in watch.calls.items() if c < MIN_CALLS}
            short.update({n: 0 for n in srv._units if n not in watch.calls})
            if short:
                raise RuntimeError(f"[{label}] units ran fewer than "
                                   f"{MIN_CALLS} times: {short}")
            units += check_programs(srv, label, report)
            sig_class = contracts.signature_class(combo)
            for name, unit in srv._units.items():
                register_signature(registry, name, sig_class, label,
                                   unit_signature(srv, unit), report)
            del srv, watch
