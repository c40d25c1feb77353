"""The port's event-rounds rows with the contended-stretch coalescer on
(``coalesce=8``) against the JAX package's ``rounds_grids``
(``kernel="xla"``), both policies over two workloads (see
test_torch_rounds.py for the grid and the tolerances)."""

import pytest

from test_torch_rounds import check_policy


@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_coalesced_rounds_grids_rows_match_reference(policy):
    port = check_policy(policy, 8)
    assert port["coalesced"].sum() > 0        # the coalescer engaged
