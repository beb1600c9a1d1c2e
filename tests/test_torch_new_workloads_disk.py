"""The LowSpace and DiskSwizzle scenarios of tests/test_torch_new_workloads.py, in a file
of their own so that no test file takes much more than a minute."""

import pytest

from tests.test_torch_new_workloads import ELSEWHERE, check
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize(
    "name", sorted(n for n, f in ELSEWHERE.items() if f == "test_torch_new_workloads_disk.py"))
def test_workload_scenario_matches_the_reference(monkeypatch, name):
    check(monkeypatch, name)
