"""§6.6.4 parameter studies over Monte-Carlo fortnights: each query
synthesizes ``seeds_per_query`` fresh fortnights of the site (the
program's ``scenarios.synthesize``, as the ``mc_grid`` kind does) and
runs every fortnight through the FLB-NUB tick simulator over the cell's
points (``core.jaxsim.simulate``: one launch of ``csrc/jaxsim.cu`` a
fortnight, a block per point). Closed loop, one operator: the next query
is sent when the last one's rows are on the host.

What the run keeps to check, drawn from the seed: in every query
``check.fortnights_per_query`` fortnights, their synthesized tables and
``check.points_per_fortnight`` of their rows. After the window the
reference makes each kept fortnight again from its seed (frozen draws
and transforms, on the CPU) and compares the tables; then it runs the
kept rows' points through the frozen tick simulator
(``reference.ticksim``, on the run's device, in float64) over the
program's tables of the fortnight and compares the rows. The simulator
moves on substep boundaries, where a last-bit difference of the card's
transforms in a submit time can shift a job by a substep; so the rows'
reference follows the program from its synthesized tables, and the table
numbers hold those tables to the reference's own.

The kind's precision control (``lower``) and the CPU tests' cut
(``small``) are the module's functions; its planted faults are in
``faults/tick_study.py``."""

from __future__ import annotations

import copy
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import compare, seeds, tables
from portbench.reference import scenarios as ref_scen
from portbench.reference import ticksim

OUTPUTS = ticksim.OUTPUTS
COUNTS = ("completed_jobs", "peak_nodes", "adjust_events")
# The program's pack precision one below the configuration's.
LOWER_PACK = {"float64": "float32"}
DAY = 86400.0
# Lanes of one reference call; the kept rows run in blocks of this many.
REF_BLOCK = 2048


def site(config: Dict, traffic: Dict) -> Dict:
    """What ``reference.scenarios.lane_tables`` needs to make a lane."""
    ws = {k: config["ws"][k] for k in ref_scen.WS_KEYS if k != "peak"}
    ws["peak"] = float(config["ws"]["peak_vms"])
    return dict(pbj={k: config["pbj"][k] for k in ref_scen.PBJ_KEYS}, ws=ws,
                duration=float(config["horizon_s"]),
                max_jobs=int(traffic["max_jobs"]),
                ws_step=float(config["ws"]["step_s"]))


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        from repro_torch.core import jaxsim
        from repro_torch.sim import scenarios
        self.sc, self.jaxsim = scenarios, jaxsim
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.points = traffic["points"]
        self.dtype = getattr(torch, traffic["options"]["dtype"])
        self.site = site(config, traffic)
        pbj, ws = self.site["pbj"], self.site["ws"]
        self.pbj = scenarios.PBJParams(**{
            k: (tuple(pbj[k]) if k == "size_probs" else float(pbj[k]))
            for k in ref_scen.PBJ_KEYS})
        self.ws = scenarios.WSParams(**{k: float(ws[k])
                                        for k in ref_scen.WS_KEYS})
        self.n_lanes = int(traffic["seeds_per_query"])
        self.lease = float(traffic["lease_s"])
        self.lb_ws = int(traffic["lb_ws"])
        self.substeps = int(traffic["substeps"])
        step = self.lease / self.substeps
        if step != self.site["ws_step"]:
            raise ValueError(f"tick_study: a substep of {step} s, but the "
                             f"WS series steps by {self.site['ws_step']} s")
        self.n_steps = int(math.ceil(self.site["duration"] / step))
        self.params = jaxsim.FLBNUBParams(**{
            k: torch.tensor([p[k] for p in self.points], dtype=torch.float32,
                            device=device) for k in "BUVG"})
        chk = traffic["check"]
        self.n_kept = int(chk["fortnights_per_query"])
        self.n_kept_points = int(chk["points_per_fortnight"])
        # (lane seed, the program's tables, [(point index, row)])
        self.kept: List = []
        self.worst: Dict[str, str] = {}
        self.rows_compared = 0

    # --------------------------------------------------------- the window
    def stages(self):
        from repro_torch.kernels import jaxsim_step
        return [("synth", self.sc, "synthesize"),
                ("simulate", jaxsim_step, "simulate_kernel"),
                ("simulate", jaxsim_step, "simulate_ref")]

    def make(self, q: int):
        stream = seeds.WARMUP if q < 0 else seeds.WINDOW
        lane_seeds = seeds.query_seeds(self.seed, stream, max(q, 0),
                                       self.n_lanes)
        grid = self.sc.ScenarioGrid(
            seeds=tuple(lane_seeds), pbj=self.pbj, ws=self.ws,
            duration=self.site["duration"], max_jobs=self.site["max_jobs"],
            ws_step=self.site["ws_step"])
        return dict(q=q, seeds=lane_seeds, grid=grid)

    def query(self, inp):
        """The fortnights' batch and their rows, ``{output: (W, P)}``."""
        batch = self.sc.synthesize(inp["grid"], device=self.device)
        dev, dt = self.device, self.dtype
        cols = [torch.from_numpy(a).to(dev, dt)
                for a in (batch.submit, batch.size, batch.runtime)]
        ws = torch.from_numpy(batch.ws_values[:, :self.n_steps]).to(dev, dt)
        outs = []
        for w in range(len(inp["seeds"])):
            n = int(batch.n_jobs[w])
            outs.append(self.jaxsim.simulate(
                self.params, *(c[w, :n] for c in cols), ws[w], self.n_steps,
                self.lease, self.lb_ws, self.substeps, device=dev))
        rows = {k: torch.stack([o[k] for o in outs]).double().cpu().numpy()
                for k in OUTPUTS}
        return batch, rows

    def lanes(self, inp) -> int:
        return len(inp["seeds"]) * len(self.points)

    def failed(self, out) -> int:
        _, rows = out
        bad = np.zeros(rows[OUTPUTS[0]].shape, bool)
        for v in rows.values():
            bad |= ~np.isfinite(v)
        return int(bad.sum())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def picks(self, q: int) -> List:
        """The (fortnight, [point indices]) query ``q`` keeps, drawn from
        the seed."""
        rng = seeds.sample_rng(self.seed, 10 ** 6 + q)
        ws = rng.choice(self.n_lanes, min(self.n_kept, self.n_lanes),
                        replace=False)
        n_pts = min(self.n_kept_points, len(self.points))
        return [(int(w), sorted(int(i) for i in rng.choice(
            len(self.points), n_pts, replace=False))) for w in ws]

    def before(self, inp):
        pass

    def keep(self, inp, out):
        if inp["q"] < 0:
            return
        batch, rows = out
        for w, idx in self.picks(inp["q"]):
            tabs = dict(submit=batch.submit[w].copy(),
                        size=batch.size[w].copy(),
                        runtime=batch.runtime[w].copy(),
                        n_jobs=int(batch.n_jobs[w]),
                        ws_values=batch.ws_values[w].copy())
            self.kept.append((inp["seeds"][w], tabs, [
                (i, {k: float(rows[k][w, i]) for k in OUTPUTS})
                for i in idx]))

    def work(self, inp):
        return None

    # -------------------------------------------------------- the check
    def reference_rows(self, items, dtype=torch.float64) -> List[Dict]:
        """The frozen tick simulator's rows of ``items``, each ``(tables,
        point index)``, in ``dtype`` on the run's device."""
        out: List[Dict] = []
        for lo in range(0, len(items), REF_BLOCK):
            block = items[lo:lo + REF_BLOCK]
            L = len(block)
            J = max(int(t["n_jobs"]) for t, _ in block)
            sub = torch.full((L, J), float("inf"), dtype=torch.float64)
            siz = torch.zeros(L, J, dtype=torch.float64)
            run = torch.zeros(L, J, dtype=torch.float64)
            ws = torch.zeros(L, self.n_steps, dtype=torch.float64)
            prm = torch.zeros(L, 4, dtype=torch.float32)
            for r, (t, i) in enumerate(block):
                n = int(t["n_jobs"])
                sub[r, :n] = torch.from_numpy(np.asarray(t["submit"][:n],
                                                         np.float64))
                siz[r, :n] = torch.from_numpy(np.asarray(t["size"][:n],
                                                         np.float64))
                run[r, :n] = torch.from_numpy(np.asarray(t["runtime"][:n],
                                                         np.float64))
                ws[r] = torch.from_numpy(np.asarray(
                    t["ws_values"][:self.n_steps], np.float64))
                prm[r] = torch.tensor([self.points[i][k] for k in "BUVG"])
            res = ticksim.simulate(
                prm.to(self.device),
                *(x.to(self.device, dtype) for x in (sub, siz, run, ws)),
                n_steps=self.n_steps, lease_seconds=self.lease,
                lb_ws=float(self.lb_ws), substeps=self.substeps)
            cols = {k: v.double().cpu().numpy() for k, v in res.items()}
            out += [{k: float(cols[k][r]) for k in OUTPUTS}
                    for r in range(L)]
        return out

    def numbers(self, kept) -> Dict[str, float]:
        """The compared numbers: each kept fortnight's tables against the
        reference's, made again in float32 from its seed; each kept row
        against the reference's row on the program's tables."""
        pairs = [(tabs, ref_scen.lane_tables(s, dtype=torch.float32,
                                              **self.site))
                 for s, tabs, _ in kept]
        nums = tables.table_numbers(pairs)
        items = [(tabs, i) for _, tabs, rows in kept for i, _ in rows]
        got = [(f"lane {s} point {self.points[i]}", row)
               for s, _, rows in kept for i, row in rows]
        want = self.reference_rows(items)
        self.rows_compared = len(want)
        rows, self.worst = row_numbers(
            [(g, w, tag) for (tag, g), w in zip(got, want)])
        nums.update(rows)
        return nums

    def check(self):
        nums = self.numbers(self.kept)
        out = compare.checks(nums, self.traffic["limits"],
                             self.traffic["compared"])
        print(f"rows compared {self.rows_compared} of "
              f"{len(self.kept)} fortnights", file=sys.stderr)
        for c in out:
            if not c["ok"] and c["name"] in self.worst:
                print(f"worst {c['name']}: {self.worst[c['name']]}",
                      file=sys.stderr)
        return out

    def control(self, n_queries: int, dtype=torch.float32):
        """The control's numbers: the reference in the program's place,
        its tick simulator run in ``dtype``, over what a window of
        ``n_queries`` queries keeps, compared as a run compares the
        program."""
        made = []
        for q in range(n_queries):
            lane_seeds = seeds.query_seeds(self.seed, seeds.WINDOW, q,
                                           self.n_lanes)
            made += [(lane_seeds[w], ref_scen.lane_tables(
                lane_seeds[w], dtype=torch.float32, **self.site), idx)
                for w, idx in self.picks(q)]
        rows = iter(self.reference_rows(
            [(tabs, i) for _, tabs, idx in made for i in idx], dtype))
        kept = [(s, tabs, [(i, next(rows)) for i in idx])
                for s, tabs, idx in made]
        return self.numbers(kept)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-9)


def row_numbers(pairs):
    """``pairs``: ``(program row, reference row, what the row is)``.
    Each number is the worst over the rows:

    * ``study_count_gap``: completed jobs, peak nodes and adjust events,
      the largest absolute difference (all are whole numbers);
    * ``study_hours_gap``: node-hours, relative difference;
    * ``study_turnaround_gap``: average turnaround, relative difference.

    Returns the numbers and, for each above 0, the row that gave it."""
    out = {"study_count_gap": 0.0, "study_hours_gap": 0.0,
           "study_turnaround_gap": 0.0}
    where: Dict[str, str] = {}
    for got, want, tag in pairs:
        for name, key, v in (
                [("study_count_gap", k, abs(got[k] - want[k]))
                 for k in COUNTS]
                + [("study_hours_gap", "node_hours",
                    _rel(got["node_hours"], want["node_hours"])),
                   ("study_turnaround_gap", "avg_turnaround",
                    _rel(got["avg_turnaround"], want["avg_turnaround"]))]):
            if not v <= out[name]:      # a NaN is the worst
                out[name] = float(v) if v == v else float("inf")
                where[name] = (f"{tag}: {key} program {got[key]!r} "
                               f"reference {want[key]!r}")
    return (out if pairs else {}), where


def lower(config: Dict, traffic: Dict):
    """The ``program`` control's ``(config, traffic)``: the program with
    its pack one precision below the configuration's (float64 ->
    float32)."""
    dtype = traffic["options"]["dtype"]
    if dtype not in LOWER_PACK:
        raise ValueError(f"tick_study: the program has no pack one "
                         f"precision below {dtype!r}")
    return config, dict(traffic, options=dict(traffic["options"],
                                              dtype=LOWER_PACK[dtype]))


def small(config: Dict, traffic: Dict, days: float, lanes: int,
          points: int):
    """The CPU tests' ``(config, traffic)``: a horizon of ``days`` with the
    job count cut in proportion, ``lanes`` fortnights a query, the first,
    middle and last of the points (at most ``points``), one fortnight a
    query kept with every point."""
    cfg, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    scale = days * DAY / cfg["horizon_s"]
    cfg["horizon_s"] = days * DAY
    cfg["pbj"]["n_jobs"] = round(cfg["pbj"]["n_jobs"] * scale)
    traffic["seeds_per_query"] = lanes
    traffic["max_jobs"] = cfg["pbj"]["n_jobs"] + 8
    pts = traffic["points"]
    traffic["points"] = [pts[0], pts[len(pts) // 2], pts[-1]][:points]
    traffic["check"] = {"fortnights_per_query": 1,
                        "points_per_fortnight": points}
    return cfg, traffic
