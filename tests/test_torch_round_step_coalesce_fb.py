"""The port's round step with the contended-stretch coalescer on
(batch 8), FB lanes, against the JAX package's Pallas kernel
(interpret mode) and its unfused reference after every chunk, in
float32 and float64 (see test_torch_round_step.py for the setup and the
tolerances)."""

import numpy as np
import pytest

from test_torch_round_step import run_against_reference


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coalesced_chunk_step_matches_reference_after_every_chunk(dtype):
    run_against_reference("fb", 8, dtype)
