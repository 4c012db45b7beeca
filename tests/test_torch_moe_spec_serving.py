"""Spec decode (K=3, greedy and sampled) of the moe and vlm families
through the port's ChunkedServer against the reference's, on the CPU:
the cases and the bar of test_torch_moe_serving.py, whose runner they
share."""

import pytest

from test_torch_moe_serving import SPEC_CASES, chunked_case
from test_torch_moe_serving import weights  # noqa: F401  (fixture)


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_chunked_server_spec_matches_reference(weights, case, monkeypatch):
    chunked_case(weights, case, SPEC_CASES[case], monkeypatch)
