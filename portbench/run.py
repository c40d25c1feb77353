"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. Set-up (the
imports, the round-step kernel's build on a checkout's first run, the
first query's inputs and one warm-up query) is timed as ``setup_s``.
Then queries run one after another, closed loop, for ``--seconds``;
with ``--trace 0`` the cell's end-to-end metrics are read from that
window, with ``--trace 1`` its per-layer metrics, from the same window
run under a profiler with every stage of the program timed. After the
window the program's outputs are held to the plain reference
(``portbench/reference``). The last lines on standard error are the
numbers compared, each beside its limit; the last line on standard
output is the result as one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.harness import guard, manifest  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else "not read"


def finite(v):
    """A number for the JSON line: an infinite or missing gap as a word
    (JSON has no infinity)."""
    if v is None or v != v or v in (float("inf"), float("-inf")):
        return str(v)
    return v


def window(drv, seconds: float, annotate: bool):
    """Queries back to back until ``seconds`` have passed; the last one
    runs to its end. Returns the window's record."""
    from torch.profiler import record_function
    lat, lanes, failed, work = [], 0, 0, [0, 0]
    q = 0
    host0 = host_seconds()
    t0 = time.perf_counter()
    t0_ns = time.time_ns()
    while True:
        inp = drv.make(q)
        drv.before(inp)
        ts = time.perf_counter()
        if annotate:
            with record_function("portbench.query"):
                out = drv.query(inp)
        else:
            out = drv.query(inp)
        te = time.perf_counter()
        lat.append(te - ts)
        lanes += drv.lanes(inp)
        failed += drv.failed(out)
        drv.keep(inp, out)
        w = drv.work(inp)
        if w is not None:
            work[0] += w[0]
            work[1] += w[1]
        del out
        q += 1
        if te - t0 >= seconds:
            break
    t1_ns = time.time_ns()
    host = {k: v - host0[k] for k, v in host_seconds().items()}
    return SimpleNamespace(latencies=lat, lanes=lanes, failed=failed,
                           queries=q, window_s=te - t0, t0_ns=t0_ns,
                           t1_ns=t1_ns, work_bytes=work[0],
                           work_ops=work[1], host=host)


def host_seconds():
    """The seconds this process has run on the host's cores, and those
    that the machine's virtual cores waited for the host
    (``/proc/stat``'s steal, summed over cores; missing where unread):
    the window's share of each says whether a slow run was short of
    cores."""
    out = {"cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None):
    """Set up, run the window and check it: ``(result, checks, run)``,
    ``run`` the window's record. On the CPU (``device="cpu"``, for the
    tests) nothing is read from a card."""
    import torch
    on_card = device != "cpu"
    drv = cell.driver_module().Driver(cell.config, cell.traffic, seed,
                                      device)
    with drv:
        drv.query(drv.make(-1))                 # warm-up: every shape
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - (t_start if t_start is not None
                                         else T_START)
        run = None
        if trace:
            from portbench.harness.stages import StageClock
            from portbench.harness.trace import DeviceTrace, marked_profile
            with StageClock(drv.stages(), sync=on_card) as clock:
                if on_card:
                    with marked_profile() as prof:
                        run = window(drv, seconds, True)
                else:
                    run = window(drv, seconds, True)
            run.stage_s = dict(clock.spent)
            run.device_trace = (DeviceTrace(prof, run.t0_ns, run.t1_ns)
                                if on_card else None)
        else:
            run = window(drv, seconds, False)
    run.setup_s = setup_s
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check()
    run.check_s = time.perf_counter() - t_check

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    readers = manifest.metric_readers(wanted)
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": run.lanes, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and run.device_trace is not None:
        dt = run.device_trace
        dev["busy_s"] = dt.busy_s
        dev["window_s"] = dt.window_s
        result["breakdown"] = {"device_ops": dt.top_ops(10),
                               "idle_gaps": dt.idle_gaps(10)}
    if on_card:
        result["power_limit"] = power_limit()
    result["checks"] = {c["name"]: {"value": finite(c["value"]),
                                    "limit": c["limit"]} for c in checks}
    return result, checks, run


def main(argv=None) -> int:
    args = parse(argv)
    man = manifest.load_manifest()
    cell = manifest.Cell(man, args.workload)
    import torch
    want = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"portbench: {want} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    result, checks, run = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace))
    lat = sorted(run.latencies)
    print("window: " + json.dumps({
        "queries": run.queries, "seconds": run.window_s,
        "latency_s_min_q1_median_q3_max": [
            lat[0], lat[len(lat) // 4], lat[len(lat) // 2],
            lat[(3 * len(lat)) // 4], lat[-1]],
        "latency_s": run.latencies, "host": run.host,
        "check_s": run.check_s}), file=sys.stderr)
    found = guard.forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
