"""Monte-Carlo policy grids: each query asks the program for one
``ScenarioGrid`` (``seeds_per_query`` fresh fortnights of the site) swept
over the cell's points, ``run_sweep_workloads(points, grid,
mode="rounds")``: one round-step launch per policy over every (lane ×
point) pair. Closed loop, one operator: the next query is sent when the
last one's rows are on the host.

What the run keeps to check, drawn from the seed: in every query
``rows_per_query`` (lane, point) rows, one from each of as many equal
blocks of the launch's lanes (the program lays them out scenario-major,
lane ``w * P + p``), and those lanes' synthesized tables. After the
window the reference makes each lane again from its seed (frozen draws
and transforms, on the CPU) and compares the tables; where the lane's
inputs agree, it runs the kept rows' points through the frozen event
engine (``harness.refpool``, on ``check.workers`` processes).

The kind's precision control (``lower``) and the CPU tests' cut
(``small``) are the module's functions; its planted faults are in
``faults/mc_grid.py``."""

from __future__ import annotations

import copy
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import compare, refpool, seeds, workcount
from portbench.reference import scenarios as ref_scen

PBJ_KEYS = ref_scen.PBJ_KEYS
WS_KEYS = ref_scen.WS_KEYS
N_PARAMS = {"fb": 2, "flb_nub": 6}
# The program's pack precision one below the configuration's.
LOWER_PACK = {"float64": "float32"}
DAY = 86400.0


def ws_params(cfg: Dict) -> Dict:
    ws = {k: cfg["ws"][k] for k in WS_KEYS if k != "peak"}
    ws["peak"] = float(cfg["ws"]["peak_vms"])
    return ws


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        from repro_torch.sim import scenarios, sweep
        self.sc, self.sweep = scenarios, sweep
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.points = traffic["points"]
        self.sweep_points = [sweep.SweepPoint(**p) for p in self.points]
        self.options = sweep.ScanOptions(**traffic.get("options", {}))
        pbj = {k: config["pbj"][k] for k in PBJ_KEYS}
        self.pbj_dict = pbj
        self.ws_dict = ws_params(config)
        self.pbj = scenarios.PBJParams(**{
            k: (tuple(pbj[k]) if k == "size_probs" else float(pbj[k]))
            for k in PBJ_KEYS})
        self.ws = scenarios.WSParams(**{k: float(self.ws_dict[k])
                                        for k in WS_KEYS})
        self.duration = float(config["horizon_s"])
        self.ws_step = float(config["ws"]["step_s"])
        self.max_jobs = int(traffic["max_jobs"])
        self.n_lanes = int(traffic["seeds_per_query"])
        chk = traffic["check"]
        self.rows_per_query = int(chk["rows_per_query"])
        self.workers = int(chk.get("workers", 1))
        # What the reference needs to make a lane (``refpool``).
        self.site = dict(pbj=self.pbj_dict, ws=self.ws_dict,
                         duration=self.duration, max_jobs=self.max_jobs,
                         ws_step=self.ws_step)
        self.kept_rows: List = []      # (lane seed, point index, row)
        self.kept_tables: Dict = {}    # lane seed -> tables
        self._want: List[int] = []
        self._orig_synth = None
        self.worst: Dict[str, str] = {}     # failed number -> its row
        self.rows_compared = self.rows_by_tables = 0

    # --------------------------------------------------------- the window
    def stages(self):
        from repro_torch.kernels import round_step as rsk
        from repro_torch.sim import rounds
        return [("synth", self.sc, "synthesize"),
                ("pack", self.sweep, "_pack_scenarios_grids"),
                ("startup", rounds, "_lane_ctx"),
                ("startup", rounds, "_startup"),
                ("startup", rsk, "lane_inputs"),
                ("kernel", rsk, "run_rounds")]

    def make(self, q: int):
        stream = seeds.WARMUP if q < 0 else seeds.WINDOW
        lane_seeds = seeds.query_seeds(self.seed, stream, max(q, 0),
                                       self.n_lanes)
        grid = self.sc.ScenarioGrid(
            seeds=tuple(lane_seeds), pbj=self.pbj, ws=self.ws,
            duration=self.duration, max_jobs=self.max_jobs,
            ws_step=self.ws_step)
        return dict(q=q, seeds=lane_seeds, grid=grid)

    def query(self, inp):
        return self.sweep.run_sweep_workloads(
            self.sweep_points, inp["grid"], mode="rounds",
            scan_options=self.options, device=self.device)

    def lanes(self, inp) -> int:
        return len(inp["seeds"]) * len(self.points)

    def failed(self, out) -> int:
        return sum(1 for rows in out for r in rows
                   if r.get("truncated", 0) or r.get("window_overflow", 0))

    def __enter__(self):
        """Keep the synthesized tables of the lanes the check draws: the
        program's ``synthesize``, as the sweep calls it, hands its batch
        on unchanged."""
        orig = self._orig_synth = self.sc.synthesize
        driver = self

        def kept(grid, device=None):
            batch = orig(grid, device=device)
            for w in driver._want:
                driver.kept_tables[grid.seeds[w]] = dict(
                    submit=batch.submit[w].copy(), size=batch.size[w].copy(),
                    runtime=batch.runtime[w].copy(),
                    n_jobs=int(batch.n_jobs[w]),
                    ws_values=batch.ws_values[w].copy())
            return batch

        self.sc.synthesize = kept
        return self

    def __exit__(self, *exc):
        self.sc.synthesize = self._orig_synth
        return False

    def row_picks(self, q: int) -> List:
        """The (lane, point) rows query ``q`` keeps, drawn from the seed:
        one from each of ``rows_per_query`` equal blocks of the launch's
        ``lanes * points`` flat lanes, so every part of the launch is
        checked."""
        rng = seeds.sample_rng(self.seed, 10 ** 6 + q)
        n_pts = len(self.points)
        edges = np.linspace(0, self.n_lanes * n_pts,
                            self.rows_per_query + 1).astype(np.int64)
        flat = [int(rng.integers(lo, max(hi, lo + 1)))
                for lo, hi in zip(edges[:-1], edges[1:])]
        return [(n // n_pts, n % n_pts) for n in flat]

    def before(self, inp):
        """Draw, before the query runs, which lanes' tables to keep."""
        self._want = [] if inp["q"] < 0 else sorted(
            {w for w, _ in self.row_picks(inp["q"])})

    def keep(self, inp, out):
        for w, i in self.row_picks(inp["q"]):
            self.kept_rows.append((inp["seeds"][w], i, dict(out[w][i])))

    def work(self, inp):
        """The round step's work for the query's lanes
        (``harness.workcount``)."""
        n_jobs = int(self.pbj_dict["n_jobs"])
        n_ws = int(math.ceil(self.duration / self.ws_step))
        nbytes = ops = 0
        for p in self.points:
            b, o = workcount.lane_work(
                n_jobs, n_ws, self.duration,
                float(p.get("lease_seconds", 3600.0)),
                N_PARAMS[p["system"]])
            nbytes += b * len(inp["seeds"])
            ops += o * len(inp["seeds"])
        return nbytes, ops

    # -------------------------------------------------------- the check
    def lane(self, seed: int, dtype=torch.float32):
        return ref_scen.lane_tables(seed, dtype=dtype, **self.site)

    def numbers(self, kept_rows, kept_tables):
        """The compared numbers of the kept rows and their lanes' tables
        against the reference, which makes each lane again in float32.
        A lane whose job sizes or WS demands the program synthesized
        otherwise than the reference (a last-bit difference of the card's
        transforms can move one) is judged by its tables alone: its rows
        ran on other inputs."""
        by_lane: Dict[int, List] = {}
        for s, i, got in kept_rows:
            by_lane.setdefault(s, []).append((i, got))
        tasks = [(s, self.site, [self.points[i] for i, _ in kept],
                  "float32", kept_tables[s]) for s, kept in by_lane.items()]
        nums: Dict[str, float] = {}
        pairs = []
        self.rows_compared = self.rows_by_tables = 0
        for s, kept, (lane_nums, wants) in zip(
                by_lane, by_lane.values(),
                refpool.rows_of(tasks, self.workers)):
            for k, v in lane_nums.items():
                nums[k] = max(nums.get(k, 0.0), v)
            if wants is None:
                self.rows_by_tables += len(kept)
                continue
            self.rows_compared += len(kept)
            pairs += [(self.points[i]["system"], got, want,
                       f"lane {s} {self.points[i]['label']}")
                      for (i, got), want in zip(kept, wants)]
        rows, self.worst = compare.row_numbers(pairs)
        nums.update(rows)
        return nums

    def check(self):
        nums = self.numbers(self.kept_rows, self.kept_tables)
        out = compare.checks(nums, self.traffic["limits"],
                             self.traffic["compared"])
        print(f"rows compared {self.rows_compared}; rows judged by their "
              f"lane's tables {self.rows_by_tables}", file=sys.stderr)
        for c in out:
            if not c["ok"] and c["name"] in self.worst:
                print(f"worst {c['name']}: {self.worst[c['name']]}",
                      file=sys.stderr)
        return out

    def control(self, n_queries: int, dtype=torch.bfloat16):
        """The control's numbers: the reference in the program's place,
        its lanes made in ``dtype``, over what a window of ``n_queries``
        queries keeps, compared as a run compares the program."""
        by_lane: Dict[int, List[int]] = {}
        for q in range(n_queries):
            lane_seeds = seeds.query_seeds(self.seed, seeds.WINDOW, q,
                                           self.n_lanes)
            for w, i in self.row_picks(q):
                by_lane.setdefault(lane_seeds[w], []).append(i)
        made = refpool.rows_of(
            [(s, self.site, [self.points[i] for i in idx], _name(dtype),
              None) for s, idx in by_lane.items()], self.workers,
            fn=refpool.made_lane)
        tabs, rows = {}, []
        for (s, idx), (t, made_rows) in zip(by_lane.items(), made):
            tabs[s] = t
            rows += [(s, i, r) for i, r in zip(idx, made_rows)]
        return self.numbers(rows, tabs)


def lower(config: Dict, traffic: Dict):
    """The ``program`` control's ``(config, traffic)``: the program with
    its pack one precision below the configuration's (float64 ->
    float32). Synthesis, float32, has no lower path in the program."""
    dtype = traffic["options"]["dtype"]
    if dtype not in LOWER_PACK:
        raise ValueError(f"mc_grid: the program has no pack one precision "
                         f"below {dtype!r}")
    return config, dict(traffic, options=dict(traffic["options"],
                                              dtype=LOWER_PACK[dtype]))


def small(config: Dict, traffic: Dict, days: float, lanes: int,
          points: int):
    """The CPU tests' ``(config, traffic)``: a horizon of ``days`` with the
    job count cut in proportion, ``lanes`` scenarios a query, the first,
    middle and last of the points (at most ``points``), three rows a
    query checked on one worker."""
    cfg, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    scale = days * DAY / cfg["horizon_s"]
    cfg["horizon_s"] = days * DAY
    cfg["pbj"]["n_jobs"] = round(cfg["pbj"]["n_jobs"] * scale)
    traffic["seeds_per_query"] = lanes
    traffic["max_jobs"] = cfg["pbj"]["n_jobs"] + 8
    pts = traffic["points"]
    traffic["points"] = [pts[0], pts[len(pts) // 2], pts[-1]][:points]
    traffic["check"] = {"rows_per_query": 3, "workers": 1}
    return cfg, traffic


def _name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]
