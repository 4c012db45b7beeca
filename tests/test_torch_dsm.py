"""The port's distributed-shared-memory layer (core/dsm.py, kernels/dsm.py)
on the CPU against the reference's core/dsm.py, exactly.

One module-scoped subprocess runs the reference on a forced 16-device
host mesh (as tests/test_distributed.py does), with meshes (16, 1),
(8, 2), (4, 4), (2, 8) and (1, 16) so that the "model" axis has 1, 2, 4,
8 and 16 ranks: the cluster sizes of the port.  It writes its inputs
(made with numpy from a seed) and outputs to an .npz; the port's
functions run on the same inputs on CPU tensors (the kernels' plain
versions) and must give the same values: integer counts and int32 ring
sums (which wrap) equal, float32 ring sums bitwise equal (both add rank
r-1, r-2, ... in that order).  A one-rank ring takes any number of
hops, as the reference's ``hops < size or size == 1`` allows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import dsm as ref_dsm
from repro_torch.core import dsm
from repro_torch.kernels import dsm as dsk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {1: (16, 1), 2: (8, 2), 4: (4, 4), 8: (2, 8), 16: (1, 16)}
NBINS = (64, 1024)


def _ilps(cs):
    """Every ILP at the portable sizes; the least and most at 1 and 16."""
    return (1, 2, 4, 8) if 1 < cs <= 8 else (1, 8)


def _hops(cs):
    if cs == 1:
        return [0, 1, 3]
    return sorted({1, min(3, cs - 1), cs - 1})


RBC_CASES = [(cs, h, i) for cs in MESHES for h in _hops(cs)
             for i in _ilps(cs)]

_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, os.path.join(%(root)r, "src"))
import numpy as np
import jax, jax.numpy as jnp
assert jax.device_count() >= 16, jax.devices()
from repro.core import dsm
from repro.launch.mesh import make_host_mesh

meshes = %(meshes)r
out = {}
rng = np.random.default_rng(0)
for cs, shape in meshes.items():
    mesh = make_host_mesh(shape, ("data", "model"))
    x = (rng.standard_normal((2 * cs, 16)) * 1e3).astype(np.float32)
    out[f"x_cs{cs}"] = x
    for hops in %(hops)r[cs]:
        for ilp in %(ilps)r[cs]:
            out[f"rbc_cs{cs}_h{hops}_i{ilp}"] = np.asarray(dsm.rbc_ring_copy(
                jnp.asarray(x), mesh, "model", hops=hops, ilp=ilp))
    xi = rng.integers(-2 ** 31, 2 ** 31, (2 * cs, 16)).astype(np.int32)
    xi[:, 0] = np.iinfo(np.int32).max          # the sums wrap
    out[f"xi_cs{cs}"] = xi
    hops = %(hops)r[cs][-1]
    out[f"rbci_cs{cs}_h{hops}"] = np.asarray(dsm.rbc_ring_copy(
        jnp.asarray(xi), mesh, "model", hops=hops, ilp=8))
    out[f"probe_cs{cs}"] = np.asarray(dsm.ring_latency_probe(mesh, "model"))
    for nbins in %(nbins)r:
        v = rng.integers(0, nbins, 8 * 128).astype(np.int32)
        out[f"vals_cs{cs}_n{nbins}"] = v
        out[f"hpriv_cs{cs}_n{nbins}"] = np.asarray(
            dsm.histogram_private_psum(jnp.asarray(v), nbins, mesh, "model"))
        out[f"hdsm_cs{cs}_n{nbins}"] = np.asarray(
            dsm.histogram_dsm(jnp.asarray(v), nbins, mesh, "model"))
    xa = rng.standard_normal((3 * cs, 2 * cs)).astype(np.float32)
    out[f"a2a_x_cs{cs}"] = xa
    out[f"a2a_cs{cs}"] = np.asarray(
        dsm.all_to_all_exchange(jnp.asarray(xa), mesh, "model"))
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dsm") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    code = _CHILD % {"root": ROOT, "meshes": MESHES,
                     "ilps": {cs: _ilps(cs) for cs in MESHES},
                     "nbins": NBINS,
                     "hops": {cs: _hops(cs) for cs in MESHES}}
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def _bitwise_equal(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("cs,hops,ilp", RBC_CASES)
def test_rbc_ring_copy_matches_reference(ref, cs, hops, ilp):
    x = torch.from_numpy(ref[f"x_cs{cs}"])
    got = dsm.rbc_ring_copy(x, cs, hops=hops, ilp=ilp)
    _bitwise_equal(got, ref[f"rbc_cs{cs}_h{hops}_i{ilp}"])


@pytest.mark.parametrize("cs", sorted(MESHES))
def test_rbc_ring_copy_int32_matches_reference(ref, cs):
    """int32 rings at ILP 8 and the most hops, with sums that wrap:
    equal."""
    hops = _hops(cs)[-1]
    x = torch.from_numpy(ref[f"xi_cs{cs}"])
    got = dsm.rbc_ring_copy(x, cs, hops=hops, ilp=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref[f"rbci_cs{cs}_h{hops}"])


@pytest.mark.parametrize("cs", sorted(MESHES))
def test_ring_latency_probe_matches_reference(ref, cs):
    got = dsm.ring_latency_probe(cs, device="cpu")
    want = ref[f"probe_cs{cs}"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want.ravel(), np.roll(np.arange(cs), 1))


@pytest.mark.parametrize("cs", sorted(MESHES))
@pytest.mark.parametrize("nbins", NBINS)
@pytest.mark.parametrize("kind", ["private", "dsm"])
def test_histograms_match_reference(ref, cs, nbins, kind):
    v = torch.from_numpy(ref[f"vals_cs{cs}_n{nbins}"])
    if kind == "private":
        got = dsm.histogram_private_psum(v, nbins, cs)
        want = ref[f"hpriv_cs{cs}_n{nbins}"]
    else:
        got = dsm.histogram_dsm(v, nbins, cs)
        want = ref[f"hdsm_cs{cs}_n{nbins}"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.bincount(ref[f"vals_cs{cs}_n{nbins}"], minlength=nbins))


@pytest.mark.parametrize("cs", sorted(MESHES))
def test_all_to_all_exchange_matches_reference(ref, cs):
    got = dsm.all_to_all_exchange(torch.from_numpy(ref[f"a2a_x_cs{cs}"]), cs)
    _bitwise_equal(got, ref[f"a2a_cs{cs}"])


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("ilp", [1, 2, 4, 8])
def test_modeled_rbc_throughput_matches_reference(cs, ilp):
    for payload in (1 << 10, 1 << 20):
        for link in (50.0, 450.0):
            assert dsm.modeled_rbc_throughput(payload, cs, ilp, link) == \
                ref_dsm.modeled_rbc_throughput(payload, cs, ilp, link)


def test_histogram_dsm_asserts_bins_split_evenly():
    v = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(AssertionError, match="split evenly"):
        dsm.histogram_dsm(v, 100, 8)
    with pytest.raises(ValueError, match="split evenly"):
        dsk.histogram_dsm(v, 100, 8)


def test_wrappers_check_their_operands_on_the_cpu():
    x = torch.zeros((6, 8))
    with pytest.raises(ValueError, match="row blocks"):
        dsk.rbc_ring_copy(x, 4)
    with pytest.raises(ValueError, match="cluster_size"):
        dsk.rbc_ring_copy(x, 3)
    with pytest.raises(ValueError, match="hops"):
        dsk.rbc_ring_copy(x, 2, hops=2)
    with pytest.raises(ValueError, match="hops"):
        dsk.rbc_ring_copy(x, 1, hops=-1)
    with pytest.raises(ValueError, match="cluster_size"):
        dsk.rbc_ring_copy(torch.zeros((32, 8)), 32)
    with pytest.raises(ValueError, match="ilp"):
        dsk.rbc_ring_copy(x[:, :6], 2, ilp=4)
    with pytest.raises(ValueError, match="ilp"):
        dsk.rbc_ring_copy(x, 2, ilp=16)
    assert torch.equal(dsk.rbc_ring_copy(x + 1, 1, hops=5, ilp=8),
                       torch.full_like(x, 6.0))
    with pytest.raises(ValueError, match="pieces"):
        dsk.all_to_all_exchange(torch.zeros((4, 3)), 4)
    with pytest.raises(ValueError, match="cluster_size"):
        dsk.ring_latency_probe(torch.zeros((3, 1), dtype=torch.int32))
    assert all(v == 0 for v in dsk.launch_counts().values())


def test_out_of_range_values_are_not_counted():
    v = torch.tensor([0, 1, -1, 8, 3, 3, 7, 100], dtype=torch.int32)
    want = torch.tensor([1, 1, 0, 2, 0, 0, 0, 1], dtype=torch.int32)
    assert torch.equal(dsk.histogram_private(v, 8, 2), want)
    assert torch.equal(dsk.histogram_dsm(v, 8, 2), want)
