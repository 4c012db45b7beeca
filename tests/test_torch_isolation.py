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
    the port's `Trainer` on the CPU, and serves and trains a step of
    the reduced moonshot-v1-16b-a3b (models/moe.py) and internvl2-1b;
(c) an entry point called without a device on a host without CUDA
    raises instead of running on the CPU (the serving entry points, the
    benchmark runner, the training CLI and `Trainer.init`);
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
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_port_serves_without_jax():
    # the scan of (a) covers every module, models/moe.py among them
    assert ROOT / "src" / "repro_torch" / "models" / "moe.py" in PORT_FILES
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD % {"src": str(ROOT / "src")}],
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
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])         # --device defaults to cuda
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


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
