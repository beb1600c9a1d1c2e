"""The three slowest specs of tests/test_torch_specs.py (DeviceFaultSwizzle,
HotShardSplit, LowSpace), in a file of their own so that no test file
takes much more than a minute.  DeviceFaultSwizzle's supervised set is the
port's DeviceConflictSet on the CPU: its metrics and census, with each
forced `device.*` class and the supervisor's degrade and re-promotion,
equal the reference's."""

import pytest

from tests.test_torch_specs import HEAVY, SPEC_DIR, _buggify_off, run_spec_compared  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("stem", HEAVY)
def test_spec_file_matches_the_reference(stem):
    assert run_spec_compared(str(SPEC_DIR / f"{stem}.txt"))["testTitle"]
