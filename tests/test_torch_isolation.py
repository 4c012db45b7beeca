"""The port stands alone: no JAX, nothing of `repro`, no silent CPU.

(a) every import in src/repro_torch and chip_smoke.py, read from the
    AST, names neither `jax` nor `repro` (`repro_torch` is fine);
(b) a subprocess where importing `jax` or `repro` fails imports the
    port, serves three requests on the CPU (paged, and open-loop on the
    contiguous layout with its SLO and windowed views, and through the
    slot baseline), runs the CLI (both engines), runs the
    dissection benchmarks tc_energy, tc_n_sweep, dpx_functions, dsm and
    te_linear (the fp8 training linear at the CPU sizes) with
    `--device cpu`, trains three steps of the reduced yi-6b through
    the port's `Trainer` on the CPU, serves and trains a step of the
    reduced moonshot-v1-16b-a3b (models/moe.py) and internvl2-1b, and
    prefills, decodes and trains a step of the reduced falcon-mamba-7b
    and zamba2-2.7b (models/ssm.py, ssm_lm.py, hybrid.py), prefills,
    decodes and takes a loss and its gradients of the reduced
    whisper-small on a `make_batch` batch (models/encdec.py), runs a
    scheduler fuzz trace (runtime/fuzz.py), compresses the gradients
    with error feedback (optim/compress.py), serves tensor-parallel at
    tp=2 on a mesh spread over the CPU with the plans, meshes, remesh
    and compressed_psum of sharding/, launch/mesh.py,
    runtime/elastic.py and optim/compress.py, trains two fsdp_tp steps
    of the sharded `Trainer` on a (2, 4) mesh spread over the CPU and
    resumes its checkpoint on one device, takes a sharded fsdp_tp loss
    and its gradients of the reduced moonshot-v1-16b-a3b,
    falcon-mamba-7b, zamba2-2.7b and whisper-small on that mesh
    (models/moe.py, ssm.py, ssm_lm.py, hybrid.py, encdec.py over
    sharding/axes.py's span reads), and runs the serving-contract
    analyzer (repro_torch.analysis) with `--device cpu --strict` and one
    serving combo, clean (tests/test_torch_analysis.py serves them all);
(c) an entry point called without a device on a host without CUDA
    raises instead of running on the CPU (the serving entry points, the
    benchmark runner, the training CLI, `Trainer.init`, and the
    analyzer's graph and kernel layers, from the CLI and their `run`);
(d) chip_smoke.py without a CUDA device exits non-zero with no result.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


_CHILD = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now fails
sys.modules["repro"] = None
sys.path.insert(0, %(src)r)
from repro_torch.configs import reduced_config
from repro_torch.models import api
from repro_torch.runtime.server import ChunkedServer, sharegpt_like_requests
from repro_torch.launch import serve
cfg = reduced_config("yi-6b")
params = api.init(cfg, 0, device="cpu")
srv = ChunkedServer(cfg, params, batch_slots=2, max_len=32, chunk=8,
                    span=4, block_size=8, device="cpu")
reqs = sharegpt_like_requests(3, cfg.vocab_size, max_input=12,
                              max_output=6, seed=1)
srv.serve(reqs)
assert all(r.done and len(r.output) == r.max_new for r in reqs)
stats = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                    "--workload", "sysprompt"])
assert stats["requests"] == 3.0
from repro_torch.models.sampling import SamplingParams
spec_srv = ChunkedServer(cfg, params, batch_slots=2, max_len=32, chunk=8,
                         span=4, block_size=8, spec_decode=2,
                         sampling=SamplingParams(temperature=0.8, seed=3),
                         device="cpu")
reqs = sharegpt_like_requests(3, cfg.vocab_size, max_input=12,
                              max_output=6, seed=1)
assert spec_srv.serve(reqs)["spec_steps"] > 0
stats = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                    "--workload", "repetitive", "--spec-decode", "3"])
assert stats["spec_k"] == 3.0
from repro_torch.runtime.arrivals import closed_stream, poisson_stream
from repro_torch.runtime.server import SlotServer, clone_requests
from repro_torch.obs import (SLOSpec, Tracer, slo_report, summary_table,
                             window_series, write_chrome_trace, write_jsonl)
from repro_torch.core import roofline
tracer = Tracer()
online = ChunkedServer(cfg, params, batch_slots=2, max_len=32, chunk=8,
                       span=4, paged=False, tracer=tracer, device="cpu")
reqs = sharegpt_like_requests(3, cfg.vocab_size, max_input=12,
                              max_output=6, seed=1)
slot_reqs = clone_requests(reqs)
assert online.serve_online(poisson_stream(reqs, 500.0))["online"] == 1.0
assert slo_report(tracer, SLOSpec(60.0, 60.0), 1.0)["met"] == 3
assert window_series(tracer, 0.01) and summary_table(tracer)
SlotServer(cfg, params, batch_slots=2, max_len=32, device="cpu").serve(
    slot_reqs)
assert [r.output for r in slot_reqs] == [r.output for r in reqs]
assert roofline.paged_decode_speedup(20, block_size=8, max_blocks=4,
                                     kv_heads=2, head_dim=16)
stats = serve.main(["--device", "cpu", "--requests", "2", "--slots", "2",
                    "--engine", "slot"])
assert stats["requests"] == 2.0
from repro_torch.benchmarks import run as bench_run
bench_run.main(["--device", "cpu", "tc_energy", "tc_n_sweep",
                "dpx_functions", "dsm", "te_linear"])
import tempfile
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.runtime.trainer import Trainer
with tempfile.TemporaryDirectory() as td:
    tr = Trainer(cfg, TrainConfig(total_steps=3, warmup_steps=1,
                                  ckpt_every=2, ckpt_dir=td),
                 data=SyntheticLMData(cfg.vocab_size, 2, 16), device="cpu")
    tr.init()
    hist = tr.run(3)
assert [m.step for m in hist] == [1, 2, 3], hist
assert all(m.loss == m.loss for m in hist)
for arch in ("moonshot-v1-16b-a3b", "internvl2-1b"):
    fcfg = reduced_config(arch)
    fparams = api.init(fcfg, 0, device="cpu")
    freqs = sharegpt_like_requests(2, fcfg.vocab_size, max_input=12,
                                   max_output=4, seed=2)
    ChunkedServer(fcfg, fparams, batch_slots=2, max_len=32, chunk=8,
                  span=4, block_size=8, device="cpu").serve(freqs)
    assert all(r.done for r in freqs)
    with tempfile.TemporaryDirectory() as td:
        tr = Trainer(fcfg, TrainConfig(total_steps=1, warmup_steps=1,
                                       ckpt_every=2, ckpt_dir=td),
                     data=SyntheticLMData(fcfg.vocab_size, 2, 16),
                     device="cpu")
        tr.init()
        assert tr.run(1)[0].loss == tr.history[0].loss
import torch
from repro_torch.models import hybrid, ssm, ssm_lm  # noqa: F401
for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
    fcfg = reduced_config(arch)
    fparams = api.init(fcfg, 0, device="cpu")
    cache = api.init_cache(fcfg, 2, 16, device="cpu")
    toks = torch.randint(0, fcfg.vocab_size, (2, 12))
    lg, cache = api.prefill(fcfg, fparams, {"tokens": toks}, cache)
    lg, cache = api.decode_step(fcfg, fparams, cache, lg.argmax(-1), 12)
    assert lg.shape == (2, fcfg.vocab_size)
    with tempfile.TemporaryDirectory() as td:
        tr = Trainer(fcfg, TrainConfig(total_steps=1, warmup_steps=1,
                                       ckpt_every=2, ckpt_dir=td),
                     data=SyntheticLMData(fcfg.vocab_size, 2, 16),
                     device="cpu")
        tr.init()
        assert tr.run(1)[0].loss == tr.history[0].loss
from repro_torch.configs.base import ShapeConfig
from repro_torch.optim import compress
from repro_torch.runtime.fuzz import run_fuzz_trace
from repro_torch.runtime.trainer import value_and_grad
wcfg = reduced_config("whisper-small")
wparams = api.init(wcfg, 0, device="cpu")
batch = api.make_batch(wcfg, ShapeConfig("t", 24, 2, "train"), 0,
                       device="cpu")
cache = api.init_cache(wcfg, 2, 16, device="cpu")
enc, cache = api.prefill(wcfg, wparams, {"frames": batch["frames"]}, cache)
lg, cache = api.decode_step(wcfg, wparams, cache,
                            torch.zeros(2, dtype=torch.int32), 0)
assert lg.shape == (2, wcfg.vocab_size) and cache["xk"].shape[2] == 24
loss, grads = value_and_grad(wcfg, wparams, batch)
g, ef = compress.apply_ef(grads, compress.make_ef_state(grads), "int8_ef")
assert loss == loss and g["embed"].shape == grads["embed"].shape
assert run_fuzz_trace(0, device="cpu").audits > 0
from repro_torch.launch.mesh import make_production_mesh, make_tp_mesh
from repro_torch.optim.compress import compressed_psum
from repro_torch.runtime import elastic
from repro_torch.sharding import plans
mesh = make_tp_mesh(2, spread="cpu")
tp_srv = ChunkedServer(cfg, params, batch_slots=2, max_len=32, chunk=8,
                       span=4, block_size=8, spec_decode=2, mesh=mesh)
reqs = sharegpt_like_requests(3, cfg.vocab_size, max_input=12,
                              max_output=6, seed=1)
assert tp_srv.serve(reqs)["tp"] == 2.0 and all(r.done for r in reqs)
assert plans.serving_plan(mesh).tp == 2
assert make_production_mesh().size == 256
assert elastic.remesh(["cpu"] * 4).shape == {"data": 1, "model": 4}
assert compressed_psum(torch.ones(3), make_tp_mesh(4, spread="cpu"),
                       "tp").tolist() == [4.0, 4.0, 4.0]
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert
hmesh = make_host_mesh((2, 4), spread="cpu")
with tempfile.TemporaryDirectory() as td:
    mtr = Trainer(cfg, TrainConfig(total_steps=2, warmup_steps=1,
                                   ckpt_every=1, ckpt_dir=td),
                  data=SyntheticLMData(cfg.vocab_size, 2, 16),
                  mesh=hmesh, plan=plans.get_plan("fsdp_tp"))
    mtr.init()
    assert len(mtr.run(2)) == 2
    one = Trainer(cfg, TrainConfig(ckpt_dir=td), device="cpu",
                  data=SyntheticLMData(cfg.vocab_size, 2, 16))
    assert one.resume() and one.step == 2
    assert torch.equal(convert.gather_params(mtr.params)["embed"],
                       one.params["embed"])
for arch in ("moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-2.7b",
             "whisper-small"):
    fcfg = reduced_config(arch)
    fb = api.make_batch(fcfg, ShapeConfig("t", 16, 2, "train"), 0,
                        device="cpu")
    fsh = convert.shard_params(api.init(fcfg, 0, device="cpu"), fcfg, hmesh,
                               rules=plans.get_plan("fsdp_tp").param_rules)
    floss, _ = value_and_grad(fcfg, fsh, fb, mesh=hmesh,
                              plan=plans.get_plan("fsdp_tp"))
    assert floss == floss, arch
from repro_torch.analysis.__main__ import main as analyze
assert analyze(["--device", "cpu", "--strict", "--max-combos", "1",
                "--repo-root", %(root)r]) == 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_port_serves_without_jax():
    # the scan of (a) covers every module, the families' among them
    for name in ("models/moe.py", "models/ssm.py", "models/ssm_lm.py",
                 "models/hybrid.py", "models/encdec.py", "runtime/fuzz.py",
                 "optim/compress.py", "sharding/axes.py",
                 "sharding/plans.py", "launch/mesh.py",
                 "runtime/elastic.py", "models/convert.py",
                 "runtime/trainer.py", "launch/train.py",
                 "ckpt/checkpoint.py", "optim/adamw.py"):
        assert ROOT / "src" / "repro_torch" / name in PORT_FILES
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD % {"src": str(ROOT / "src"),
                                         "root": str(ROOT)}],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.runtime.server import ChunkedServer
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChunkedServer(cfg, params, batch_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg, device="cuda")
    from repro_torch.configs.base import ShapeConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_batch(cfg, ShapeConfig("t", 8, 2, "train"))
    from repro_torch.runtime.fuzz import run_fuzz_trace
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fuzz_trace(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])         # --device defaults to cuda
    from repro_torch.launch.mesh import make_tp_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tp", "2", "--spread", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tp_mesh(2, spread="cuda")
    with pytest.raises(ValueError, match="spread"):
        make_tp_mesh(2)                         # no CUDA device to take
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.core import bench
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_run.main(["tc_energy"])           # --device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_all(["tc_energy"])
    from repro_torch.core import dsm
    with pytest.raises(RuntimeError, match="CUDA"):
        dsm.ring_latency_probe(4)               # device defaults to cuda
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import Trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])            # --device defaults to cuda
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)),
                 data=SyntheticLMData(cfg.vocab_size, 2, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.init()                               # no device: cuda
    from repro_torch.analysis.__main__ import main as analyze
    for layer in ("graph", "kernel"):           # --device defaults to cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            analyze(["--layer", layer])
    from repro_torch.analysis import graph_check, kernel_lint
    from repro_torch.analysis.report import Report
    for layer in (graph_check, kernel_lint):    # device defaults to cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            layer.run(Report())
    assert analyze(["--layer", "ast", "--repo-root", str(ROOT)]) == 0


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
