"""The port's live tier against the JAX package's.

* ``repro_torch.core.runtime_bridge.LiveCloud`` (a copy) driven through
  one trace writes the reference ``LiveCloud``'s ``DecisionLedger``,
  entry for entry, with and without a fault schedule, and the same
  ledger as the port's event engine in checkpoint-preempt mode
  (``tests/test_faults.py`` and ``tests/test_live_vs_sim.py``'s
  identities, across the two packages).
* ``repro_torch.serving.replay.replay`` gives the reference's row,
  ledger, demand curves and request counts on the paper pair at the
  live benchmark's ``--tiny`` size, inside ``CONTRACTS["live"]`` of the
  port's event engine; and under faults, the same grant retries and
  shed requests.
* ``GrantBackoff`` and the admission throttle behave as in the
  reference (``tests/test_faults.py``'s serving-layer cases).
* A live training job (``submit_training``: a reduced smollm
  ``TrainJob`` on ``mesh="cpu"``) is preempted by a WS spike, which
  checkpoints it, resumes after the spike and completes all its steps,
  writing the reference ``LiveCloud``'s ledger (a JAX ``TrainJob``
  payload) entry for entry; the preempt hook checkpoints a stub payload
  and pins its progress to the payload's step.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from repro.core.jobs import Job as RefJob
from repro.core.runtime_bridge import LiveCloud as RefLiveCloud
from repro.launch.mesh import make_local_mesh
from repro.serving import autoscaler as ref_autoscaler
from repro.serving.replay import replay as ref_replay
from repro.sim import faults as ref_faults
from repro.sim import traces as ref_traces
from repro_torch.core.jobs import Job
from repro_torch.core.pbj_manager import PBJPolicyParams
from repro_torch.core.runtime_bridge import LiveCloud, LiveJob
from repro_torch.core.ws_manager import InstanceAdjustmentPolicy
from repro_torch.serving.autoscaler import AutoscaledService, GrantBackoff
from repro_torch.serving.engine import Request, VirtualReplica
from repro_torch.serving.replay import replay
from repro_torch.sim import faults
from repro_torch.sim.contracts import LIVE_CONTRACT
from repro_torch.sim.engine import build_fb, clone_jobs, run_sim
from repro_torch.sim.pump import DecisionLedger
from test_torch_faults import chaos_schedule, chaos_workload

DAY = 24 * 3600.0
CKPT = PBJPolicyParams(checkpoint_preempt=True)


def entries(ledger):
    return [dataclasses.astuple(e) for e in ledger.entries]


def both(rows):
    """``(port jobs, reference jobs)`` from ``(submit, size, runtime)``
    rows."""
    return ([Job(jid=i, submit=s, size=z, runtime=r)
             for i, (s, z, r) in enumerate(rows)],
            [RefJob(jid=i, submit=s, size=z, runtime=r)
             for i, (s, z, r) in enumerate(rows)])


def random_workload(seed, n_jobs=24, horizon=16 * 3600.0):
    """``tests/test_live_vs_sim.py``'s ``random_workload``."""
    rng = random.Random(seed)
    rows = [(rng.uniform(0.0, horizon), 2 ** rng.randrange(0, 3),
             rng.uniform(600.0, 2.5 * 3600.0)) for _ in range(n_jobs)]
    ws = [(k * 1800.0, rng.randrange(0, 7)) for k in range(12)]
    return both(rows), ws


def paper_pair(capacity=16, horizon=DAY, peak=8, n=40):
    """The live benchmark's ``nasa+worldcup`` lane at its ``--tiny``
    size (``benchmarks/run.py`` ``live_benchmark``)."""
    rows = [(j.submit, min(j.size, capacity // 2), j.runtime)
            for j in ref_traces.nasa_ipsc(seed=0)
            if j.submit < horizon * 0.6][:n]
    ws = ref_traces.worldcup98(seed=0, peak_vms=peak, duration=horizon)
    return both(rows), ws


def run_clouds(jobs, ws, capacity, lease, horizon, schedules=None):
    """The trace through the port's and the reference's ``LiveCloud``;
    returns both clouds and their job lists."""
    d0 = max((int(d) for t, d in sorted(ws) if t <= 0), default=0)
    out = []
    for cls, js, sched in ((LiveCloud, jobs[0], schedules and schedules[0]),
                           (RefLiveCloud, jobs[1],
                            schedules and schedules[1])):
        cloud = cls(capacity, lease_seconds=lease, duration=horizon,
                    ws_initial=d0)
        run_jobs = [dataclasses.replace(j) for j in js]
        cloud.load_trace(run_jobs, ws_trace=ws, lease_ticks=True)
        if sched is not None:
            cloud.inject_faults(sched)
        cloud.run_until(horizon)
        out.append((cloud, run_jobs))
    return out


# ------------------------------------------------------- ledger identity

def test_live_cloud_ledger_equals_reference_without_faults():
    jobs, ws = random_workload(3)
    (port, port_jobs), (ref, ref_jobs) = run_clouds(jobs, ws, 16, 3600.0,
                                                    DAY)
    assert len(port.ledger.entries) > 20
    assert entries(port.ledger) == entries(ref.ledger)
    assert [j.completed for j in port_jobs] == \
        [j.completed for j in ref_jobs]
    sim_led = DecisionLedger()
    run_sim(build_fb(16, params=CKPT), clone_jobs(jobs[0]), ws,
            duration=DAY, ledger=sim_led)
    assert port.ledger.entries == sim_led.entries


def test_live_cloud_ledger_equals_reference_under_faults():
    port_jobs, ref_jobs, ws = chaos_workload(1)
    jobs = (port_jobs, ref_jobs)
    scheds = (chaos_schedule(faults), chaos_schedule(ref_faults))
    (port, port_jobs), (ref, ref_jobs) = run_clouds(jobs, ws, 12, 3600.0,
                                                    DAY, scheds)
    assert entries(port.ledger) == entries(ref.ledger)
    assert port.ledger.kills("fail") > 0        # chaos actually engaged
    assert [(j.completed, j.kills) for j in port_jobs] == \
        [(j.completed, j.kills) for j in ref_jobs]
    sim_led = DecisionLedger()
    sim_jobs = clone_jobs(jobs[0])
    run_sim(build_fb(12, 3600.0, params=CKPT), sim_jobs, ws, duration=DAY,
            ledger=sim_led, faults=scheds[0])
    assert port.ledger.entries == sim_led.entries
    assert sum(j.completed for j in port_jobs) == \
        sum(j.completed for j in sim_jobs)


# ------------------------------------------------ live training payloads

def preempt_and_resume(cloud, root):
    """``tests/test_serving_and_bridge.py``'s live scenario: FB policy, a
    WS spike preempts the training job via checkpoint, the job resumes
    after the spike recedes and completes. Returns the payload."""
    cloud.submit_training(jid=1, arch="smollm_135m", chips=6, steps=20)
    assert 1 in cloud.pbj.running
    cloud.run_quantum(steps=5)
    payload = cloud._live[1].payload
    assert payload.step >= 5
    cloud.preempt_for_ws(5)                # 8 - 5 < 6: preempted
    assert 1 not in cloud.pbj.running
    assert cloud.service.cluster.allocated("WS") == 5
    assert list((root / "job1").rglob("*")), \
        "preempt did not write a checkpoint"
    step_at_preempt = payload.step
    cloud.set_ws_demand(1)
    cloud.lease_tick()
    assert 1 in cloud.pbj.running
    finished = []
    for _ in range(6):
        finished = cloud.run_quantum(steps=5)
        if finished:
            break
    assert finished == [1]
    assert payload.step == 20 >= step_at_preempt
    return payload


def test_live_cloud_preempt_and_resume_on_the_cpu(tmp_path):
    cloud = LiveCloud(capacity=8, mesh="cpu", checkpoint_root=str(tmp_path))
    payload = preempt_and_resume(cloud, tmp_path)
    assert payload.device == torch.device("cpu")
    assert payload.model.impl == "torch"
    assert len(payload.history) == 20 and all(np.isfinite(payload.history))
    # each quantum's run ends in a checkpoint; the last three are kept
    assert payload.ckpt.all_steps() == [10, 15, 20]


def test_live_training_ledger_equals_reference(tmp_path):
    port = LiveCloud(capacity=8, mesh="cpu",
                     checkpoint_root=str(tmp_path / "port"))
    ref = RefLiveCloud(capacity=8, mesh=make_local_mesh(),
                       checkpoint_root=str(tmp_path / "ref"))
    preempt_and_resume(port, tmp_path / "port")
    preempt_and_resume(ref, tmp_path / "ref")
    assert len(port.ledger.entries) > 3
    assert entries(port.ledger) == entries(ref.ledger)
    assert port.ledger.kills("ws") == ref.ledger.kills("ws") == 1


class _StubPayload:
    """Stands in for TrainJob in hook tests: counts checkpoints."""

    def __init__(self, step=7):
        self.step = step
        self.checkpoints = 0

    def checkpoint(self, block=False):
        self.checkpoints += 1


def test_preempt_hook_checkpoints_live_victims():
    """A live job killed by a WS spike gets a checkpoint call at the
    manager's kill site, and its queue entry's progress is pinned to the
    payload's step count (``tests/test_serving_and_bridge.py``)."""
    cloud = LiveCloud(capacity=8, lease_seconds=60.0)
    job = Job(jid=9, submit=0.0, size=6, runtime=30.0)
    stub = _StubPayload(step=7)
    cloud._live[9] = LiveJob(job, stub)
    cloud.submit_job(job)
    assert 9 in cloud.pbj.running
    assert cloud.preempt_for_ws(5) == [9]
    assert stub.checkpoints == 1
    assert job.progress == 7.0
    assert 9 in [j.jid for j in cloud.pbj.queue]


# ---------------------------------------------------------------- replay

def assert_replays_equal(got, want):
    assert got.row.row() == want.row.row()
    assert entries(got.ledger) == entries(want.ledger)
    assert got.trace_demand == want.trace_demand
    assert got.derived_demand == want.derived_demand
    for k in ("requests_completed", "peak_instances", "shed_requests",
              "grant_retries"):
        assert getattr(got, k) == getattr(want, k), k


def test_replay_paper_pair_equals_reference_and_holds_live_contract():
    jobs, ws = paper_pair()
    got = replay(clone_jobs(jobs[0]), ws, 16, duration=DAY, serve_dt=30.0)
    want = ref_replay([dataclasses.replace(j) for j in jobs[1]], ws, 16,
                      duration=DAY, serve_dt=30.0)
    assert_replays_equal(got, want)
    assert got.requests_completed > 0
    ref = run_sim(build_fb(16, params=CKPT), clone_jobs(jobs[0]), ws,
                  duration=DAY, name="event")
    assert LIVE_CONTRACT.check_live(
        got.row.row(), ref.row(), got.derived_demand, got.trace_demand,
        DAY) == []
    assert got.row.completed_jobs == ref.completed_jobs


def test_replay_under_faults_equals_reference():
    """The serving chaos lane's machinery (fault schedule, admission
    shedding at max_queue, the seeded grant backoff) on the paper pair."""
    jobs, ws = paper_pair()
    scheds = [chaos_schedule(m, capacity=16, mtbf_h=2.0)
              for m in (faults, ref_faults)]
    got = replay(clone_jobs(jobs[0]), ws, 16, duration=DAY, serve_dt=30.0,
                 faults=scheds[0], max_queue=64)
    want = ref_replay([dataclasses.replace(j) for j in jobs[1]], ws, 16,
                      duration=DAY, serve_dt=30.0, faults=scheds[1],
                      max_queue=64)
    assert_replays_equal(got, want)
    assert got.ledger.kills("fail") > 0 and got.requests_completed > 0


# ------------------------------------------- serving-layer degradation

def test_grant_backoff_deterministic_bounded_and_as_reference():
    a = GrantBackoff(base=30.0, max_delay=240.0, max_retries=5, seed=7)
    b = ref_autoscaler.GrantBackoff(base=30.0, max_delay=240.0,
                                    max_retries=5, seed=7)
    da = [a.next_delay() for _ in range(7)]
    assert da == [b.next_delay() for _ in range(7)]
    assert sum(d is not None for d in da) == 5
    assert da[5] is None and da[6] is None
    for i, d in enumerate(da[:5]):
        cap = min(30.0 * 2 ** i, 240.0)
        assert cap / 2 < d <= cap
    a.reset()
    assert a.next_delay() is not None
    with pytest.raises(ValueError):
        GrantBackoff(base=0.0)
    with pytest.raises(ValueError):
        GrantBackoff(base=10.0, max_delay=5.0)


def test_admission_throttle_sheds_and_counts():
    svc = AutoscaledService(
        policy=InstanceAdjustmentPolicy(initial_instances=1,
                                        min_instances=1,
                                        nodes_per_instance=1),
        slots_per_replica=2, max_queue=2,
        replica_factory=lambda: VirtualReplica(2))
    admitted = sum(
        svc.submit(Request(rid=i, prompt=np.zeros(2, np.int32),
                           max_new_tokens=2), now=0.0)
        for i in range(5))
    assert admitted == 2
    assert svc.shed_requests == 3
    assert len(svc.queue) == 2


def test_replay_with_outage_backs_off_recovers_and_equals_reference():
    """A full-capacity outage mid-replay: grants come back short, the
    driver retries on the bounded backoff, and service recovers after
    the repair — with the reference's counts."""
    horizon = 6 * 3600.0
    ws = [(0.0, 2), (600.0, 4)]
    kw = dict(capacity=6, duration=horizon, serve_dt=60.0,
              lease_seconds=1800.0, max_queue=512)
    t, d = np.array([3600.0, 3600.0 + 1800.0]), np.array([6, -6])
    res = replay([], ws, faults=faults.FaultSchedule(t, d), **kw)
    assert res.grant_retries >= 1
    assert res.ledger.sheds() > 0
    assert res.requests_completed > 0
    assert res.row.peak_nodes <= 6
    assert_replays_equal(
        res, ref_replay([], ws, faults=ref_faults.FaultSchedule(t, d), **kw))
