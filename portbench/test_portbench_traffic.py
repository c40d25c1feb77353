"""Traffic made from the seed: the same seed gives the same queries, no
query repeats another's inputs, and large seeds are taken."""

import pytest

from portbench.harness import manifest, seeds
from portbench.smallcell import small_cell

BIG = 2 ** 31 + 12345
MAN = manifest.with_parked(manifest.load_manifest())


def test_query_seeds_repeat_per_seed_and_differ_per_query():
    a = seeds.query_seeds(BIG, seeds.WINDOW, 3, 256)
    assert a == seeds.query_seeds(BIG, seeds.WINDOW, 3, 256)
    assert len(set(a)) == 256
    others = set(seeds.query_seeds(BIG, seeds.WINDOW, 4, 256)) \
        | set(seeds.query_seeds(BIG, seeds.WARMUP, 3, 256)) \
        | set(seeds.query_seeds(BIG + 1, seeds.WINDOW, 3, 256))
    assert not set(a) & others
    assert all(0 <= s < 2 ** 63 for s in a)


@pytest.mark.parametrize("name", [
    c for c in manifest.cell_names(MAN)
    if manifest.Cell(MAN, c).kind == "mc_grid"])
def test_mc_queries_are_deterministic(name):
    cell = small_cell(name)
    drv = lambda s: cell.driver_module().Driver(cell.config, cell.traffic,
                                                s, "cpu")
    a, b, c = drv(BIG), drv(BIG), drv(BIG + 1)
    assert a.make(2)["grid"] == b.make(2)["grid"]
    assert a.make(2)["grid"] != c.make(2)["grid"]
    assert a.row_picks(5) == b.row_picks(5)


def test_row_picks_cover_every_block_of_the_launch():
    cell = manifest.Cell(MAN, "ipsc_wc98.mc_fb")
    drv = cell.driver_module().Driver(cell.config, cell.traffic, BIG, "cpu")
    n_pts, k = len(drv.points), drv.rows_per_query
    block = drv.n_lanes * n_pts // k
    for q in (0, 7):
        picks = drv.row_picks(q)
        flat = sorted(w * n_pts + i for w, i in picks)
        assert [n // block for n in flat] == list(range(k))
        assert all(0 <= w < drv.n_lanes and 0 <= i < n_pts
                   for w, i in picks)
    assert drv.row_picks(0) != drv.row_picks(1)


@pytest.mark.parametrize("name", [
    c for c in manifest.cell_names(MAN)
    if manifest.Cell(MAN, c).kind == "tick_study"])
def test_study_queries_and_picks_are_deterministic(name):
    cell = manifest.Cell(MAN, name)
    drv = lambda s: cell.driver_module().Driver(cell.config, cell.traffic,
                                                s, "cpu")
    a, b, c = drv(BIG), drv(BIG), drv(BIG + 1)
    assert a.make(2)["grid"] == b.make(2)["grid"]
    assert a.make(2)["grid"] != c.make(2)["grid"]
    assert a.picks(5) == b.picks(5) and a.picks(5) != a.picks(6)
    picks = a.picks(5)
    assert len(picks) == a.n_kept and len({w for w, _ in picks}) == a.n_kept
    assert all(len(set(i)) == a.n_kept_points and max(i) < len(a.points)
               for _, i in picks)
    assert a.n_steps * a.lease / a.substeps >= cell.config["horizon_s"]
