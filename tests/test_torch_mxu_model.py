"""The port's hardware registry, tile model, timer and benchmark
registry against the reference's.

Given the reference's chip (``hw.TPU_V5E``) every number of the port's
``mxu_model`` equals the reference's exactly: both are pure Python
floats computed in the same order.  The port's benchmarks run on the
CPU (the kernels' plain versions) and name their rows as the
reference's do, up to the device label and the target chip's name.
"""

import dataclasses

import numpy as np
import pytest

import benchmarks.async_copy as ref_async_copy
import benchmarks.tensorcore as ref_tensorcore
from repro.core import bench as ref_bench
from repro.core import hw as ref_hw
from repro.core import mxu_model as ref_mm
from repro.core.timer import Timing as RefTiming
from repro_torch.core import bench, hw, mxu_model
from repro_torch.core.timer import Timing, measure

DTYPES = ["float32", "bfloat16", "int8", "float8_e4m3fn", "float8_e5m2"]
SHAPES = [(128, 128, 128), (256, 512, 64), (96, 200, 72), (8, 8, 8),
          (4096, 4096, 4096), (1, 130, 129), (2048, 11008, 4096)]
PROPS = ["flops", "hbm_bytes", "arithmetic_intensity", "compute_s",
         "memory_s", "bound", "predicted_flops_per_s", "utilization"]


def test_reference_chips_carried_over():
    for name, ref_chip in ref_hw.CHIPS.items():
        assert dataclasses.asdict(hw.CHIPS[name]) == \
            dataclasses.asdict(ref_chip)
        for d in DTYPES + ["tf32", "fp8", "float16"]:
            assert hw.CHIPS[name].peak_for(d) == ref_chip.peak_for(d)
    assert hw.TARGET is hw.H100_SXM
    assert hw.H100_SXM.vmem_bytes == 232448
    assert hw.H100_SXM.peak_for("bfloat16") == 989.4e12
    assert hw.H100_SXM.peak_for("float8_e4m3fn") == 1978.9e12
    assert hw.H100_SXM.peak_for("float32") == 66.9e12
    assert hw.H100_SXM.hbm_gbps == 3350.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_model_equals_reference_on_v5e(dtype):
    port, ref = hw.TPU_V5E, ref_hw.TPU_V5E
    for (m, n, k) in SHAPES:
        assert mxu_model.alignment_efficiency(m, n, k) == \
            ref_mm.alignment_efficiency(m, n, k)
        assert mxu_model.tile_latency_cycles(m, n, k, dtype) == \
            ref_mm.tile_latency_cycles(m, n, k, dtype)
        assert list(mxu_model.candidate_tiles(m, n, k)) == \
            list(ref_mm.candidate_tiles(m, n, k))
        for stages in (1, 2, 3):
            assert mxu_model.vmem_working_set(m, n, k, dtype, stages) == \
                ref_mm.vmem_working_set(m, n, k, dtype, stages)
            for tile in ((128, 128, 128), (64, 256, 512), (8, 32, 16)):
                a = mxu_model.MatmulModel(m, n, k, *tile, dtype, port, stages)
                b = ref_mm.MatmulModel(m, n, k, *tile, dtype, ref, stages)
                for p in PROPS:
                    assert getattr(a, p) == getattr(b, p), (p, m, n, k, tile)
                assert a.fits_vmem() == b.fits_vmem()
            got = mxu_model.pick_tile(m, n, k, dtype, chip=port,
                                      stages=stages)
            want = ref_mm.pick_tile(m, n, k, dtype, chip=ref, stages=stages)
            assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk)
            assert got.predicted_flops_per_s == want.predicted_flops_per_s
    assert mxu_model.n_sweep(dtype=dtype, chip=port) == \
        ref_mm.n_sweep(dtype=dtype, chip=ref)


def test_tile_model_defaults_to_the_h100():
    t = mxu_model.pick_tile(256, 256, 256, "float32", stages=1)
    assert t.chip is hw.H100_SXM and (t.bm, t.bn, t.bk) == (128, 128, 128)
    rows = mxu_model.n_sweep()
    assert [r["bn"] for r in rows] == [8, 16, 32, 64, 128, 256, 512]
    assert rows[-1]["tflops"] <= hw.H100_SXM.peak_for("bfloat16") / 1e12


@pytest.mark.parametrize("derived", [None, 0.0, 1.23456, 1e12])
def test_timing_row_equals_reference(derived):
    args = ("mma/float32/m128n128k128", 12.34567, 0.5, 5, derived, "x")
    assert Timing(*args).row() == RefTiming(*args).row()


def test_measure_on_the_host_clock_for_cpu_work():
    calls = []
    t = measure(lambda: calls.append(1), name="n", warmup=0, reps=5,
                inner=2)
    assert t.name == "n" and t.reps == 5 and t.us_per_call >= 0
    assert len(calls) == 1 + 5 * 2          # one warm-up call at least


def test_registry_names_and_paper_refs():
    from repro_torch.benchmarks import run  # noqa: F401  (registers)
    import benchmarks.run  # noqa: F401  (registers the reference's)
    port, ref = bench.registry(), ref_bench.registry()
    names = ["tc_mma", "tc_wgmma", "tc_n_sweep", "tc_energy", "async_copy",
             "dpx_functions", "dpx_kernels", "dsm"]
    assert sorted(port) == sorted(names)
    for n in names:
        assert port[n].paper_ref == ref[n].paper_ref


def _ref_rows(fn, module, seed, monkeypatch):
    """The reference benchmark's rows, with its timing stubbed out (the
    names do not depend on it) and its RNG restored afterwards."""
    monkeypatch.setattr(module, "RNG", np.random.default_rng(seed))
    monkeypatch.setattr(module, "measure",
                        lambda f, name="", **kw: RefTiming(name, 1.0, 0.0, 1))
    return [t.name for t in fn()]


@pytest.mark.parametrize("name", ["tc_mma", "tc_wgmma", "tc_n_sweep",
                                  "tc_energy", "async_copy"])
def test_benchmark_rows_named_as_reference(name, monkeypatch):
    """Run on the CPU, each benchmark's rows are the reference's with
    `cpu` for the device label and the H100's name for `v5e`; the
    energy table adds the H100's rows.  Measured rows carry a TFLOP/s."""
    from repro_torch.benchmarks import async_copy, tensorcore
    port_fn = bench.registry()[name].fn
    ref_fn = {"tc_mma": ref_tensorcore.mma_table,
              "tc_wgmma": ref_tensorcore.wgmma_table,
              "tc_n_sweep": ref_tensorcore.n_sweep,
              "tc_energy": ref_tensorcore.energy_model,
              "async_copy": ref_async_copy.async_copy}[name]
    ref_mod = ref_async_copy if name == "async_copy" else ref_tensorcore
    port_mod = async_copy if name == "async_copy" else tensorcore
    seed = 17 if name == "async_copy" else 3
    want = [n.replace("(v5e)", f"({hw.TARGET.name})")
            for n in _ref_rows(ref_fn, ref_mod, seed, monkeypatch)]
    monkeypatch.setattr(port_mod, "RNG", np.random.default_rng(seed))
    rows = port_fn("cpu")
    got = [t.name for t in rows]
    if name == "tc_energy":
        extra = [f"model/{hw.TARGET.name}/bf16", f"model/{hw.TARGET.name}/int8"]
        assert [n for n in got if n not in extra] == want
        assert all(n in got for n in extra)
    else:
        assert got == want
    for t in rows:
        if t.us_per_call > 0:
            assert t.derived is not None and t.derived > 0
            assert t.derived_name == "TFLOPs(cpu)"
