"""The port's serving tier against the JAX package's, on the CPU.

The same weights (the JAX ``Model.init(0)`` tree through
``convert.params_from_jax``) and the same request schedule
(numpy-seeded prompts of mixed lengths) go through the JAX ``Replica``
and the port's ``Replica`` in float32, the ``Replica`` default: the
generated token lists must be identical. Then an ``AutoscaledService``
of each package, fed one fixed burst, must scale through the same
instance trace and complete the same requests with the same tokens.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.mesh import make_local_mesh
from repro.serving.autoscaler import AutoscaledService as RefService
from repro.serving.engine import Replica as RefReplica
from repro.serving.engine import Request as RefRequest
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.autoscaler import AutoscaledService
from repro_torch.serving.engine import (LeastLoadedRouter, Replica, Request,
                                        VirtualReplica)

ARCH = "gemma2_2b"          # reduced: window 64, both softcaps
MAX_NEW = 6


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced_config(ref_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    ref_rep = RefReplica(ref_cfg, make_local_mesh(), slots=1, max_len=8)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, ref_rep.params)))
    return ref_cfg, cfg, ref_rep.params, model


def _schedule(vocab, n, lengths, seed=5):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(lengths[i % len(lengths)]))
             .astype(np.int32)) for i in range(n)]


def _serve(replica, request_cls, schedule, steps):
    """Admit requests as slots free up; step until all are done."""
    pending = [request_cls(rid=i, prompt=p, max_new_tokens=MAX_NEW)
               for i, p in schedule]
    done = []
    for _ in range(steps):
        while pending and replica.admit(pending[0]):
            pending.pop(0)
        done += replica.step()
        if not pending and not replica.active:
            break
    return {r.rid: [int(t) for t in r.output] for r in done}


def test_replica_tokens_equal_reference(weights):
    ref_cfg, cfg, ref_params, model = weights
    # Mixed prompt lengths, two past the reduced window of 64.
    sched = _schedule(cfg.vocab, 5, [3, 70, 12, 66, 9])
    ref = RefReplica(ref_cfg, make_local_mesh(), slots=3, max_len=96,
                     params=ref_params)
    port = Replica(cfg, "cpu", slots=3, max_len=96, params=model)
    want = _serve(ref, RefRequest, sched, 40)
    got = _serve(port, Request, sched, 40)
    assert len(want) == 5
    assert got == want
    assert all(len(t) == MAX_NEW + 1 for t in got.values())


def _burst(service, request_cls, schedule, ticks):
    trace = []
    for tick in range(ticks):
        if tick == 0:
            for i, p in schedule:
                service.submit(request_cls(rid=i, prompt=p,
                                           max_new_tokens=MAX_NEW),
                               now=0.0)
        service.tick(now=float(tick))
        trace.append(len(service.replicas))
    return trace, {r.rid: [int(t) for t in r.output]
                   for r in service.completed}


def test_autoscaled_service_trace_equals_reference(weights):
    ref_cfg, cfg, ref_params, model = weights
    sched = _schedule(cfg.vocab, 10, [8])
    ref = RefService(ref_cfg, make_local_mesh(), slots_per_replica=2,
                     max_len=24, params=ref_params)
    port = AutoscaledService(cfg, "cpu", slots_per_replica=2, max_len=24,
                             params=model)
    want_trace, want_out = _burst(ref, RefRequest, sched, 45)
    got_trace, got_out = _burst(port, Request, sched, 45)
    assert max(want_trace) > want_trace[0], "the burst never scaled up"
    assert got_trace == want_trace
    assert len(got_out) == len(want_out) == 10
    assert got_out == want_out
    # Replicas share the one set of weights.
    assert all(r.params is model for r in port.replicas)


def test_replica_per_slot_positions_and_router():
    cfg = reduced_config(get_config("smollm_135m"))
    rep = Replica(cfg, "cpu", slots=2, max_len=32)
    rng = np.random.default_rng(0)
    assert rep.admit(Request(0, rng.integers(0, cfg.vocab, 3), 4))
    assert rep.admit(Request(1, rng.integers(0, cfg.vocab, 8), 4))
    assert list(rep.pos) == [3, 8] and rep.free_slot() is None
    rep.step()
    assert list(rep.pos) == [4, 9]
    k = rep.cache["l0"]["k"]          # (periods, slots, kv, L, hd)
    assert float(k[:, 0, :, 3].abs().max()) > 0
    assert float(k[:, 0, :, 4:].abs().max()) == 0
    assert float(k[:, 1, :, 8].abs().max()) > 0
    other = Replica(cfg, "cpu", slots=2, max_len=32, params=rep.params)
    assert other.params is rep.params
    assert LeastLoadedRouter().route([rep, other]) is other
    virt = VirtualReplica(slots=1)
    assert virt.admit(Request(2, np.zeros(2, np.int32), 2))
    assert virt.step() == [] and len(virt.step()) == 1


def test_serve_cli_runs_reduced_on_cpu(capsys):
    out = serve.main(["--arch", "smollm_135m", "--requests", "6",
                      "--ticks", "60", "--prompt-len", "5", "--max-new", "3",
                      "--device", "cpu"])
    assert out["completed"] == 6
    assert out["throughput_tokens"] == 6 * 4
    assert out["device"] == "cpu"
    assert '"completed": 6' in capsys.readouterr().out
