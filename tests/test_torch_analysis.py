"""The port's serving-contract analyzer (repro_torch.analysis) on the CPU.

Every registered rule fires exactly once on its seeded violation (AST
cases are source strings written to tmp_path and scanned with
``paths=``; graph cases run toy ``WorkUnit`` bodies; launch cases are
plan records); the three layers are clean on the repo, the workload
sweep and every serving flag combo (the acceptance gate, as
``python -m repro_torch.analysis --device cpu --strict``).  Held
against the reference: the report's JSON and exit codes, the rule IDs
and severities (JX004 too), the workload sweep's names and calls, and
the flag combos (``kernel`` folded; with two mesh positions the
tensor-parallel combos too, served on a mesh laid on the CPU).  The two
faults the scan found are held here too: ``ops.pipelined_matmul`` with the reference's 128^3
tiles, and ``ops.fp8_matmul``'s auto tiles off the warpgroup grid.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import ast_lint, contracts, graph_check, kernel_lint
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.report import RULES, Finding, Report
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops
from repro_torch.models.common import mark
from repro_torch.runtime.graphs import WorkUnit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")


# ----------------------------------------------------------------------
# layer 3: one source string per AST violation
# ----------------------------------------------------------------------

def _scan(tmp_path, name, source, **kw):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(source))
    rep = Report()
    ast_lint.run(rep, paths=[str(path)], repo_root=str(tmp_path),
                 **{"roots": [], "parity_bodies": {}, **kw})
    return rep


@pytest.mark.parametrize("call", [
    "x.item()", "x.cpu()", "x.tolist()", "x.numpy()",
    "torch.cuda.synchronize()", "done.synchronize()",
    "torch.cuda.current_stream().synchronize()", "np.asarray(x)",
    "np.random.gumbel(size=3)", "random.random()"])
def test_ast001_host_transfer_in_a_unit_body_fires(tmp_path, call):
    rep = _scan(tmp_path, "hot", f"""
        import random
        import numpy as np
        import torch

        def helper(x, done):
            return {call}

        def hot_impl(x, done):
            return helper(x, done) + 1

        def cold(x):
            return x.item()          # not reachable from the root
        """, roots=[("hot", "hot_impl")])
    assert rep.count("AST001") == 1
    assert len(rep.findings) == 1


def test_ast001_follows_imports_inside_functions(tmp_path):
    (tmp_path / "lib.py").write_text("def read(x):\n    return x.item()\n")
    (tmp_path / "hot.py").write_text(
        "def hot_impl(x):\n    import lib\n    return lib.read(x)\n")
    rep = Report()
    ast_lint.run(rep, paths=[str(tmp_path / "hot.py"),
                             str(tmp_path / "lib.py")],
                 repo_root=str(tmp_path), roots=[("hot", "hot_impl")],
                 parity_bodies={})
    assert rep.count("AST001") == 1
    assert rep.findings[0].detail["function"] == "read"


@pytest.mark.parametrize("expr", [
    "q @ k", "torch.matmul(q, k)", "torch.einsum('bd,td->bt', q, k)",
    "F.linear(q, k)", "torch.bmm(q, k)", "q.mm(k)"])
def test_ast002_product_in_a_parity_body_fires(tmp_path, expr):
    rep = _scan(tmp_path, "attn", f"""
        import torch
        import torch.nn.functional as F

        def decode_attention(q, k):
            return ({expr}).sum(-1)

        def other(q, k):
            return q @ k             # not a parity body
        """, parity_bodies={"attn.py": {"decode_attention"}})
    assert rep.count("AST002") == 1
    assert len(rep.findings) == 1


_SERVER = """
    import numpy as np
    import torch
    from repro_torch.runtime.graphs import WorkUnit

    class Server:
        def __init__(self):
            self.pos = np.zeros(2, np.int32)
            self.buf = torch.zeros(2)
            self.units = {{"step": WorkUnit("step", self._body, "cpu")}}
            self.other = self._unit("prefill", self._prefill)

        def _unit(self, name, body):
            return WorkUnit(name, body, "cpu")

        def _body(self, tok):
            self.buf[0] = tok.sum()  # in place: not a rebind
            return ({body_read},)

        def _prefill(self, tok):
            return (self._helper(tok),)

        def _helper(self, tok):
            return tok + {helper_read}

        def dispatch(self):
            self.buf[1] = 1.0
            self.pos = self.pos + 1  # the rebind a graph never sees
"""


@pytest.mark.parametrize("body_read,helper_read,where", [
    ("torch.as_tensor(self.pos)", "1", "_body"),
    ("tok", "torch.as_tensor(self.pos)", "_helper")])
def test_ast003_rebound_state_read_by_a_unit_body_fires(tmp_path, body_read,
                                                        helper_read, where):
    rep = _scan(tmp_path, "srv", _SERVER.format(body_read=body_read,
                                                helper_read=helper_read))
    assert rep.count("AST003") == 1
    assert len(rep.findings) == 1
    f = rep.findings[0]
    assert (f.detail["attr"], f.detail["function"]) == ("pos", where)


def test_ast003_in_place_writes_are_not_rebinds(tmp_path):
    rep = _scan(tmp_path, "srv", _SERVER.format(body_read="self.buf",
                                                helper_read="self.buf"))
    assert rep.findings == []


def test_ast_unit_bodies_of_the_servers():
    info = ast_lint.parse_module(
        os.path.join(SRC, "repro_torch", "runtime", "server.py"), REPO_ROOT)
    bodies = {c: set(ast_lint.unit_bodies(n)) for c, n in info.classes.items()}
    assert bodies["ChunkedServer"] == {"_chunk_body", "_span_body",
                                       "_spec_body", "_cow_body"}
    assert bodies["SlotServer"] == {"_decode_body", "_prefill_body"}
    roots = {(m, q) for m, q in contracts.HOT_PATH_ROOTS}
    assert roots == {("repro_torch.runtime.server", f"{c}.{b}")
                     for c, bs in bodies.items() for b in bs}


def test_ast_scan_covers_the_serving_modules():
    scanned = {os.path.relpath(p, REPO_ROOT)
               for p in ast_lint.collect_paths(REPO_ROOT)}
    for rel in ("src/repro_torch/runtime/server.py",
                "src/repro_torch/runtime/arrivals.py",
                "src/repro_torch/models/attention.py",
                "src/repro_torch/obs/tracer.py",
                "src/repro_torch/kernels/paged_attention.py"):
        assert rel in scanned, f"{rel} escapes the AST gate"


# ----------------------------------------------------------------------
# layer 1: toy work units
# ----------------------------------------------------------------------

class _ToyServer:
    """The state a UnitWatch reads, with one unit of `body`."""

    def __init__(self, body, name="chunk_step"):
        self.device = torch.device("cpu")
        self.cache = {"k": torch.zeros(4, 8), "v": torch.zeros(4, 8)}
        self.cur_tok = torch.zeros(2, dtype=torch.int32)
        self.out_buf = torch.zeros(2, 8, dtype=torch.int32)
        self.spec_decode = 0
        self._units = {name: WorkUnit(name, lambda x: body(self, x), "cpu")}

    def call(self, n=1):
        for i in range(n):
            self._units[next(iter(self._units))].run(
                np.full(4, i, np.float32))


def _clean(srv, x):
    srv.cache["k"].add_(x[:, None])
    srv.cache["v"][:, 0] = x
    mark(x, contracts.SERVING_TAG)
    return (x * 2,)


def _watch(body, name="chunk_step", calls=1):
    rep = Report()
    srv = _ToyServer(body, name)
    graph_check.UnitWatch(srv, "toy", rep)
    srv.call(calls)
    return rep, srv


def test_toy_unit_is_clean():
    rep, srv = _watch(_clean, calls=3)
    assert rep.findings == []
    assert graph_check.check_programs(srv, "toy", rep)[0]["programs"] == 1
    assert rep.findings == []


def _host_read(srv, x):
    if int(x.sum()) >= 0:            # a host read of a device value
        return _clean(srv, x)
    return _clean(srv, -x)


def _dynamic(srv, x):
    torch.nonzero(x > 0)
    return _clean(srv, x)


def _unwritten(srv, x):
    srv.cache["v"][:, 0] = x
    mark(x, contracts.SERVING_TAG)
    return (x,)


def _moved(srv, x):
    out = _clean(srv, x)
    srv.cache["k"] = srv.cache["k"].clone()     # a new pool each call
    return out


def _unmarked(srv, x):
    srv.cache["k"].add_(1.0)
    srv.cache["v"].add_(1.0)
    return (x,)


@pytest.mark.parametrize("rule,body", [
    ("JX001", _host_read), ("JX002", _dynamic), ("JX003", _unwritten),
    ("JX003", _moved), ("JX006", _unmarked)],
    ids=["JX001", "JX002", "JX003-unwritten", "JX003-moved", "JX006"])
def test_graph_rule_fires_on_its_toy_unit(rule, body):
    rep, _ = _watch(body)
    assert rep.count(rule) == 1, [str(f) for f in rep.findings]
    assert len(rep.findings) == 1


def _bf16_partials(srv, x):
    from repro_torch.models.common import fixed_tree_sum
    parts = torch.stack([x, x]).to(torch.bfloat16)     # not float32
    fixed_tree_sum(parts, tag="xshard_attn_out")
    return _clean(srv, x)


def test_jx004_fires_on_a_bf16_cross_shard_partial():
    rep, _ = _watch(_bf16_partials)
    assert rep.count("JX004") == 1, [str(f) for f in rep.findings]
    assert len(rep.findings) == 1


def test_jx006_is_for_forward_units_only():
    rep, _ = _watch(_unmarked, name="cow_copy")
    assert rep.findings == []


def test_jx005_signature_drift_fires():
    rep = Report()
    registry = {}
    for label, width in (("combo-a", 8), ("combo-b", 16)):
        graph_check.register_signature(
            registry, "chunk_step", "paged=1,fp8_kv=0", label,
            [["operand[0]", [2, width], "<i4"]], rep)
    assert rep.count("JX005") == 1
    assert len(rep.findings) == 1


def test_jx005_unit_that_never_ran_fires():
    rep = Report()
    srv = _ToyServer(_clean)
    graph_check.check_programs(srv, "toy", rep)
    assert rep.count("JX005") == 1
    assert len(rep.findings) == 1


# ----------------------------------------------------------------------
# layer 2: one plan record per launch rule
# ----------------------------------------------------------------------

def _launch(**kw):
    base = dict(kernel="seed", module="seed", workload="seed",
                entry="seed_fwd", body="mma_sync", grid=(1,))
    base.update(kw)
    return kernel_lint.Launch(**base)


@pytest.mark.parametrize("rule,kw", [
    ("KL001", dict(tiles={"bm": (256, 128)})),
    ("KL002", dict(cover={"rows": (64, 128)})),
    ("KL003", dict(tiles={"bn": (96, 256)}, on_wgmma_grid=False,
                   grid_tile_fits=True)),
    ("KL004", dict(tiles={"bm": (24, 64)}, fragment={"bm": 16})),
    ("KL005", dict(smem=contracts.SMEM_LIMIT + 1))])
def test_launch_rule_fires_on_its_record(rule, kw):
    rep = Report()
    kernel_lint.check_launches([_launch(**kw)], rep)
    assert rep.count(rule) == 1
    assert len(rep.findings) == 1


def test_kl003_from_the_tile_rule():
    """A tile the rule sends to mma_sync where a grid tile fits warns;
    an operand narrower than every grid tile (decode rows) does not."""
    for dtype, tiles in ((torch.bfloat16, (128, 32, 64)),
                         (torch.float8_e4m3fn, (128, 256, 128))):
        rep = Report()
        launch = kernel_lint.plan_matmul("seed", dtype, 512, 512, 512,
                                         *tiles, fp8=dtype.itemsize == 1)
        assert launch.body == "mma_sync"
        kernel_lint.check_launches([launch], rep)
        assert [f.rule for f in rep.findings] == ["KL003"]
    rep = Report()
    launch = kernel_lint.plan_matmul("seed", torch.bfloat16, 8, 128, 256)
    kernel_lint.check_launches([launch], rep)
    assert launch.body == "mma_sync" and rep.findings == []


def test_plan_mismatch_raises():
    planned = [_launch(args=(1, 2))]
    assert kernel_lint.match_launches(planned, [("seed_fwd", (1, 2))]) == 1
    with pytest.raises(kernel_lint.PlanMismatch):
        kernel_lint.match_launches(planned, [("seed_fwd", (1, 3))])
    with pytest.raises(kernel_lint.PlanMismatch):
        kernel_lint.match_launches(planned, [("seed_fwd", (1, 2))] * 2)


# ----------------------------------------------------------------------
# clean runs on the repo
# ----------------------------------------------------------------------

def test_ast_layer_clean_on_repo():
    rep = Report()
    ast_lint.run(rep, repo_root=REPO_ROOT)
    assert rep.findings == [], [str(f) for f in rep.findings]
    assert rep.extras["ast_hot_functions"] >= 60


def test_ast_layer_refuses_a_scan_without_the_unit_bodies(tmp_path):
    """From a root that holds no port (the wrong cwd) the AST layer
    raises instead of passing on nothing, from the CLI too."""
    with pytest.raises(FileNotFoundError, match="roots"):
        ast_lint.run(Report(), repo_root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="roots"):
        main(["--layer", "ast", "--repo-root", str(tmp_path)])


def test_kernel_layer_clean_on_workload_sweep():
    rep = Report()
    kernel_lint.run(rep, device="cpu")
    assert rep.findings == [], [str(f) for f in rep.findings]
    assert len(rep.extras["kernel_launches"]) == 13
    assert rep.extras["kernel_launches_matched"] is None    # CPU: plans


def test_graph_layer_clean_across_serving_combos():
    """Every flag combo serves clean; one signature per unit within a
    cache layout; every unit one program after 3+ calls."""
    rep = Report()
    graph_check.run(rep, device="cpu")
    assert rep.findings == [], [str(f) for f in rep.findings]
    assert len(rep.extras["combos"]) == 13
    regs = rep.extras["signatures"]
    assert set(regs) == {"chunk_step", "decode_span", "verify_step",
                         "cow_copy"}
    # the default paged/bf16 layout: prefix, spec, eos, fp8_linear and
    # sampling switches all hash identical
    assert len(regs["chunk_step"]["paged=1,fp8_kv=0"]["combos"]) == 8
    units = rep.extras["graph_units"]
    assert len(units) == 42
    assert all(u["calls"] >= graph_check.MIN_CALLS and u["programs"] == 1
               for u in units)


def test_graph_layer_clean_on_the_tp_combos():
    """The tensor-parallel combos (a mesh of two positions laid on the
    CPU) serve clean beside their tp=1 layouts, each unit one program,
    their signatures (the cache at its logical shape) those of tp=1."""
    rep = Report()
    tp_combos = contracts.serving_combos(device_count=2)[13:]
    assert tp_combos == [{"tp": 2}, {"tp": 2, "spec_decode": 3},
                         {"tp": 2, "fp8_kv": True}]
    graph_check.run(rep, device="cpu",
                    combos=[{}, {"fp8_kv": True}] + tp_combos)
    assert rep.findings == [], [str(f) for f in rep.findings]
    regs = rep.extras["signatures"]
    assert len(regs["chunk_step"]["paged=1,fp8_kv=0"]["combos"]) == 3
    assert len(regs["chunk_step"]["paged=1,fp8_kv=1"]["combos"]) == 2
    assert len(regs["verify_step"]["paged=1,fp8_kv=0"]["combos"]) == 1
    units = rep.extras["graph_units"]
    assert len(units) == 16
    assert all(u["calls"] >= graph_check.MIN_CALLS and u["programs"] == 1
               for u in units)


def test_cli_strict_clean_and_fp8_sweep_clean(tmp_path):
    out = tmp_path / "report.json"
    assert main(["--strict", "--device", "cpu", "--layer", "kernel",
                 "--layer", "ast", "--repo-root", REPO_ROOT,
                 "--report", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["findings"] == [] and rep["suppressed"] == []
    assert any("[fp8_matmul_256]" in x for x in rep["kernel_launches"])
    fp8 = kernel_lint.default_workloads()[3]
    assert fp8.name == "fp8_matmul_256"
    assert fp8.plan()[0].body == "wgmma"


# ----------------------------------------------------------------------
# report plumbing and the CLI
# ----------------------------------------------------------------------

def test_unknown_suppress_rule_rejected():
    with pytest.raises(ValueError):
        Report(suppress=["NOPE"])
    with pytest.raises(ValueError):
        Report(suppress=["JX007"])          # no such rule
    assert Report(suppress=["JX004"]).suppress == {"JX004"}


def test_warning_severity_gates_only_strict():
    rep = Report()
    rep.add(Finding("KL003", "seed"))
    assert rep.exit_code(strict=False) == 0
    assert rep.exit_code(strict=True) == 1
    rep.add(Finding("KL001", "seed"))
    assert rep.exit_code(strict=False) == 1


def test_suppressed_findings_do_not_fail():
    rep = Report(suppress=["KL001"])
    rep.add(Finding("KL001", "seed"))
    assert rep.exit_code(strict=True) == 0 and len(rep.suppressed) == 1


def test_cli_list_rules_and_ast_layer(capsys):
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.split()
    assert all(rule in listed for rule in RULES)
    assert main(["--layer", "ast", "--repo-root", REPO_ROOT]) == 0


def test_launch_analyze_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--strict",
         "--layer", "ast", "--repo-root", REPO_ROOT],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clean: 0 findings" in proc.stdout


# ----------------------------------------------------------------------
# held against the reference
# ----------------------------------------------------------------------

def test_rules_are_the_references_but_jx004():
    """Every rule of the reference, JX004 too now that the port serves
    tensor-parallel, at the reference's severity."""
    from repro.analysis.report import RULES as REF_RULES
    assert set(RULES) == set(REF_RULES)
    assert {r: s for r, (s, _) in RULES.items()} == \
        {r: s for r, (s, _) in REF_RULES.items()}


def test_report_json_and_exit_codes_equal_the_references():
    from repro.analysis.report import Finding as RefFinding
    from repro.analysis.report import Report as RefReport
    cases = [("KL003", "warn", "", 0, {}),
             ("JX001", "host", "src/x.py", 7, {"op": "item"}),
             ("AST002", "dot", "a.py", 3, {"function": "f"})]
    for suppress in ([], ["KL003"], ["JX001", "AST002"]):
        for n in range(len(cases) + 1):
            port, ref = Report(suppress=suppress), RefReport(
                suppress=suppress)
            for rule, msg, path, line, detail in cases[:n]:
                port.add(Finding(rule, msg, path, line, dict(detail)))
                ref.add(RefFinding(rule, msg, path, line, dict(detail)))
            for strict in (False, True):
                assert port.exit_code(strict) == ref.exit_code(strict)
                got, want = (json.loads(r.to_json(strict=strict))
                             for r in (port, ref))
                for side in (got, want):     # descriptions are the port's
                    for f in side["findings"] + side["suppressed"]:
                        assert f["severity"] in ("error", "warning")
                assert got == want


def _ref_call(thunk):
    """(function name, operand shapes and dtypes, other kwargs) of a
    reference workload thunk (its closure holds fn, args, kw)."""
    cells = dict(zip(thunk.__code__.co_freevars,
                     (c.cell_contents for c in thunk.__closure__)))
    args, kw = cells["args"], dict(cells["kw"])
    shapes = [(tuple(a.shape), str(a.dtype)) for a in args]
    for name in ("k_scale", "v_scale"):
        if name in kw:
            shapes.append((tuple(kw.pop(name).shape), "float32"))
    return cells["fn"].__name__, shapes, kw


def _port_call(workload, monkeypatch):
    from repro_torch.kernels import paged_attention as pk
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*args, **kw):
            scales = [kw.pop(n) for n in ("k_scale", "v_scale") if n in kw]
            calls.append((name, [(tuple(a.shape), str(a.dtype).replace(
                "torch.", "")) for a in list(args) + scales
                if isinstance(a, torch.Tensor)], kw))
            return real(*args, **kw, **dict(zip(("k_scale", "v_scale"),
                                                scales)))
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("matmul", "fp8_matmul", "flash_attention",
                 "tropical_matmul", "smith_waterman", "pipelined_matmul"):
        spy(ops, name)
    for name in ("paged_decode", "paged_chunk", "paged_decode_fp8",
                 "paged_chunk_fp8"):
        spy(pk, name)
    workload.run(torch.device("cpu"))
    monkeypatch.undo()
    assert len(calls) == 1
    return calls[0]


def test_workload_sweep_is_the_references(monkeypatch):
    from repro.analysis import kernel_lint as ref_lint
    ref = ref_lint.default_workloads()
    port = kernel_lint.default_workloads()
    assert [w.name for w in port] == [name for name, _ in ref]
    paged = {("paged_decode_attention", False): "paged_decode",
             ("paged_decode_attention", True): "paged_decode_fp8",
             ("paged_chunk_attention", False): "paged_chunk",
             ("paged_chunk_attention", True): "paged_chunk_fp8"}
    for w, (_, thunk) in zip(port, ref):
        name, shapes, kw = _ref_call(thunk)
        name = paged.get((name, len(shapes) == 7), name)
        assert _port_call(w, monkeypatch) == (name, shapes, kw), w.name


def test_combos_are_the_references_with_kernel_folded():
    from repro.analysis import contracts as ref_contracts

    def key(combo):
        out = {k: v for k, v in combo.items() if k != "kernel"}
        if "sampling" in out:
            s = out["sampling"]
            out["sampling"] = (s.temperature, s.top_k, s.top_p, s.seed)
        return sorted(out.items())

    folded = []
    for combo in ref_contracts.serving_combos(1):
        if key(combo) not in folded:
            folded.append(key(combo))
    assert [key(c) for c in contracts.serving_combos()] == folded
    assert contracts.serving_combos(max_combos=4) == \
        contracts.serving_combos()[:4]
    for combo in contracts.serving_combos():
        ref_like = dict(combo, kernel=combo.get("paged", True))
        assert contracts.signature_class(combo) == \
            ref_contracts.signature_class(ref_like)


def test_tp_combos_are_the_references_with_kernel_folded():
    from repro.analysis import contracts as ref_contracts

    def key(combo):
        out = {k: v for k, v in combo.items()
               if k != "kernel" and k != "sampling"}
        return sorted(out.items())

    folded = []
    for combo in ref_contracts.serving_combos(2)[16:]:
        if key(combo) not in folded:
            folded.append(key(combo))
    assert [key(c) for c in contracts.serving_combos(device_count=2)[13:]] \
        == folded
    for combo in contracts.serving_combos(device_count=2):
        assert contracts.signature_class(combo) == \
            ref_contracts.signature_class(dict(combo, kernel=True))
    assert contracts.combo_label({"tp": 2}).split(",")[5] == "tp=2"


# ----------------------------------------------------------------------
# the faults the scan found
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 256, 256), (512, 512, 512),
                                   (2048, 11008, 4096)])
def test_auto_tiles_run_wgmma(shape):
    """ops' auto tiles lie on the warpgroup grid of every dtype that has
    one (the sweep's unrestricted fp8 tile (128, 256, 128) ran mma_sync,
    ~38x slower than wgmma at full width on the H100)."""
    for dtype in (torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16,
                  torch.int8):
        tiles = ops.product_tiles(*shape, dtype)
        assert mmk.body(dtype, *shape, *tiles) == "wgmma", (dtype, tiles)


def test_pipelined_matmul_takes_the_references_128_tiles():
    """The reference's sweep runs ops.pipelined_matmul at 128^3 tiles and
    two stages; two 128-deep slices of a 128 x 128 tile pass an H100
    block's shared memory, so the port halves the slice (one product,
    each output summed in K order)."""
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((128, 128)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(ref_ops.pipelined_matmul(
        jnp.asarray(a), jnp.asarray(b), bm=128, bn=128, bk=128))
    got = ops.pipelined_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               bm=128, bn=128, bk=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert ops.pipelined_tiles(128, 128, 128, 128, 128, 128, 2) == \
        (128, 128, 64)
    assert ops.pipelined_tiles(128, 128, 128, 128, 128, 128, 1) == \
        (128, 128, 128)
