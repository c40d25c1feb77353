"""The port's chaos tier with the contended-stretch coalescer on (batch
8): ``fb_rounds_row(..., faults=)`` equals the JAX package's
``kernel="xla"`` row on ``tests/test_faults.py``'s chaos workload, in
float32 and float64, exact except the three time integrals (see
``test_torch_faults.py``, which holds the batch-1 rows)."""

import numpy as np
import pytest

from test_torch_faults import assert_fault_row_equals_reference


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fault_row_equals_reference_xla_row_coalesced(dtype):
    assert_fault_row_equals_reference(dtype, 8)
