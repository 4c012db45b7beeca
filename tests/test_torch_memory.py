"""The memory-hierarchy kernels' plain versions and their chain on the CPU
(paper Tables IV and V; kernels/memory.py, csrc/memory.cu).

* ``pointer_chain`` is the chain the reference's host chase builds
  (benchmarks/memory.py ``_pchase_latency_ns``), entry for entry, for
  the same seed and size, read out of the reference's own code: one
  cycle through every entry;
* each plain version's result: the chase's last index after warm +
  iters hops (the walk's), the stream bitwise ``2x + 1``, the on-chip
  read's wrapping checksum;
* the wrappers take the plain version only for CPU tensors (no launch),
  check their operands, and the benchmarks raise without CUDA unless
  the caller names the CPU.
The kernels are held against these on the card in tests/test_torch_gpu.py
and chip_smoke.py phase 11.
"""

import numpy as np
import pytest
import torch

import benchmarks.memory as ref_memory
from repro_torch.kernels import build
from repro_torch.kernels import memory


def _reference_chain(size_bytes, monkeypatch) -> np.ndarray:
    """The chain the reference's host chase walks, caught where it
    allocates it."""
    made = []

    class _Numpy:
        def __getattr__(self, name):
            return getattr(np, name)

        def empty(self, *args, **kwargs):
            made.append(np.empty(*args, **kwargs))
            return made[-1]

    monkeypatch.setattr(ref_memory, "np", _Numpy())
    ref_memory._pchase_latency_ns(size_bytes, iters=1)
    assert len(made) == 1
    return made[0]


@pytest.mark.parametrize("size", [64, 16 << 10, 256 << 10, 8 << 20])
def test_chain_equals_the_references(size, monkeypatch):
    want = _reference_chain(size, monkeypatch)
    got = memory.pointer_chain(size)
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_chain_is_one_cycle_through_every_entry():
    nxt = memory.pointer_chain(1 << 14)
    seen, i = np.zeros(len(nxt), bool), 0
    for _ in range(len(nxt)):
        seen[i] = True
        i = nxt[i]
    assert i == 0 and seen.all()


@pytest.mark.parametrize("warm,iters", [(0, 1), (2048, 100), (7, 4096)])
def test_pchase_plain_walks_the_chain(warm, iters):
    nxt = memory.pointer_chain(16 << 10)
    i = 0
    for _ in range(warm + iters):
        i = nxt[i]
    for load in memory.LOADS:
        out = memory.pchase(torch.tensor(nxt), load, iters=iters,
                            warm=warm)
        assert out.dtype == torch.int64 and out.shape == (3,)
        assert int(out[0]) == i and int(out[1]) == 0 and int(out[2]) >= 0


def test_stream_plain_is_bitwise_two_x_plus_one():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4099) * 10.0 ** rng.integers(-30, 30, 4099))
    x = x.astype(np.float32)
    x[:4] = [0.0, -0.0, 3e38, -1.5]
    with np.errstate(over="ignore"):
        want = x * np.float32(2) + np.float32(1)
    got = memory.stream(torch.from_numpy(x), passes=3).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mode", sorted(memory.BW_MODES))
def test_onchip_bw_plain_checksum_wraps(mode):
    src = torch.from_numpy(np.random.default_rng(1).integers(
        -2 ** 31, 2 ** 31, memory.BW_WORDS).astype(np.int32))
    sums, cycles = memory.onchip_bw(src, mode, reps=24)
    words = sum(int(w) & 0xFFFFFFFF for w in src.tolist())
    assert sums.tolist() == [(24 * words) % 2 ** 32]
    assert cycles.tolist() == [0]
    assert memory.onchip_bw_plain(src, 24, 3)[0].tolist() == \
        [(24 * words) % 2 ** 32] * 3


def test_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's launch")

    monkeypatch.setattr(build, "launch", no_launch)
    memory.reset_launch_counts()
    nxt = torch.tensor(memory.pointer_chain(4096))
    memory.pchase(nxt, "shared", iters=8)
    memory.stream(torch.ones(16))
    memory.onchip_bw(torch.zeros(memory.BW_WORDS, dtype=torch.int32),
                     reps=8)
    assert memory.launch_counts() == {"pchase": 0, "stream": 0,
                                      "onchip_bw": 0}


def test_wrappers_check_their_operands():
    nxt = torch.tensor(memory.pointer_chain(1 << 20))     # 1 MB
    with pytest.raises(ValueError, match="shared memory"):
        memory.pchase(nxt, "shared", iters=8)
    with pytest.raises(ValueError, match="load"):
        memory.pchase(nxt, "l3", iters=8)
    with pytest.raises(ValueError, match="int64"):
        memory.pchase(nxt.int(), "cg", iters=8)
    with pytest.raises(ValueError, match="out of range"):
        memory.pchase(nxt, "cg", iters=8, warm=-1)
    with pytest.raises(ValueError, match="float32"):
        memory.stream(torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="passes"):
        memory.stream(torch.ones(8), passes=0)
    src = torch.zeros(memory.BW_WORDS, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        memory.onchip_bw(src, reps=12)
    with pytest.raises(ValueError, match="mode"):
        memory.onchip_bw(src, "l2", reps=8)
    with pytest.raises(ValueError, match="words"):
        memory.onchip_bw(src[:100], reps=8)


def test_benchmarks_raise_without_cuda_unless_told_cpu(monkeypatch):
    from repro_torch.benchmarks import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("memory_latency", "memory_throughput", "te_linear",
                 "te_layer"):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_run.main([name])
