"""The port's ``TrainJob`` against the JAX package's, on the CPU.

* The reference's trainer cases, mirrored on ``device="cpu"``: the loss
  drops over 25 steps; preempt → checkpoint → a new job resumes at the
  step it stopped; worker failure: a job killed after step 13 whose
  checkpoints past step 10 are lost, replaced by a new job that restores
  at 10 and finishes, gives the uninterrupted run's losses from step 10
  on — bit for bit (the reference asks rtol 1e-5; on one CPU the port's
  arithmetic is deterministic).
* ``SyntheticLM`` batches equal the reference's bit for bit (a copied
  module: numpy only), frontend included.
* Ten steps of the port's ``TrainJob`` and the reference's from the same
  weights (the reference's ``init``): loss histories within rtol 1e-5
  (AdamW on float32 gradients that differ in their summation order),
  for adamw (smollm) and adafactor (reduced llama-vision, with its
  frontend).
* ``launch.train`` runs on ``--device cpu``; ``TrainJob`` with no device
  asks for the card and raises without one; its model runs ``impl
  ="torch"`` and trains with no kernel launch.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.mesh import make_local_mesh
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.trainer import TrainJob as RefTrainJob
from repro.train.trainer import TrainJobConfig as RefTrainJobConfig
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.trainer import TrainJob, TrainJobConfig

CPU = "cpu"
HISTORY_RTOL = 1e-5


def _cfg(arch="smollm_135m"):
    return reduced_config(get_config(arch))


def test_train_job_runs_and_loss_drops(tmp_path):
    job = TrainJob(_cfg(), TrainJobConfig(
        arch="smollm_135m", steps=25, batch=8, seq_len=32, lr=3e-3,
        checkpoint_dir=str(tmp_path), checkpoint_every=10), CPU)
    result = job.run()
    assert result["completed"]
    assert result["step"] == 25
    assert job.model.impl == "torch"
    first = np.mean(job.history[:5])
    last = np.mean(job.history[-5:])
    assert last < first, f"loss did not drop: {first} -> {last}"
    assert len(job.grad_norms) == 25 and all(np.isfinite(job.grad_norms))
    assert job.ckpt.all_steps() == [10, 20, 25]


def test_preempt_checkpoint_resume(tmp_path):
    """The PhoenixCloud FB kill becomes checkpoint-preempt: a preempted
    job resumes from its checkpoint with the step counter intact."""
    cfg = _cfg()
    jc = TrainJobConfig(arch="smollm_135m", steps=20, batch=4, seq_len=32,
                        checkpoint_dir=str(tmp_path), checkpoint_every=5)
    job = TrainJob(cfg, jc, CPU)
    job.initialize()
    job.jc = TrainJobConfig(**{**jc.__dict__, "steps": 8})
    job.run()                      # run to step 8, checkpoints at 5 + final
    job.checkpoint(block=True)
    assert job.step == 8
    job2 = TrainJob(cfg, jc, CPU)
    job2.initialize()
    assert job2.step == 8          # resumed, not restarted
    for a, b in zip(job.model.parameters(), job2.model.parameters()):
        assert torch.equal(a, b)
    assert int(job2.opt_state["count"]) == 8
    result = job2.run()
    assert result["completed"] and job2.step == 20


def test_preempt_stops_the_run_loop(tmp_path):
    """``preempt()`` while a step runs: the loop stops after that step
    and the final checkpoint holds it."""
    jc = TrainJobConfig(arch="smollm_135m", steps=10, batch=2, seq_len=16,
                        checkpoint_dir=str(tmp_path), checkpoint_every=50)
    job = TrainJob(_cfg(), jc, CPU)
    job.initialize()
    loss = job.model.loss

    def loss_then_preempt(batch):
        job.preempt()
        return loss(batch)

    job.model.loss = loss_then_preempt
    result = job.run()
    assert result["step"] == 1 and not result["completed"]
    assert job.ckpt.all_steps() == [1]


def _worker_failure_run(tmp_path, cfg, arch):
    mk = lambda d, steps: TrainJobConfig(
        arch=arch, steps=steps, batch=4, seq_len=32, lr=1e-3,
        checkpoint_dir=d, checkpoint_every=10)
    ref = TrainJob(cfg, mk(str(tmp_path / "ref"), 20), CPU)
    ref.run()
    a = TrainJob(cfg, mk(str(tmp_path / "ha"), 20), CPU)
    a.jc = TrainJobConfig(**{**a.jc.__dict__, "steps": 13})
    a.run()
    for s in a.ckpt.all_steps():
        if s > 10:
            shutil.rmtree(str(tmp_path / "ha" / f"step_{s}"))
    del a
    b = TrainJob(cfg, mk(str(tmp_path / "ha"), 20), CPU)
    result = b.run()
    return ref, b, result


def test_worker_failure_is_loss_equivalent(tmp_path):
    ref, b, result = _worker_failure_run(tmp_path, _cfg(), "smollm_135m")
    assert result["completed"] and b.step == 20
    assert b.history == ref.history[10:20]
    for p, q in zip(ref.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("arch", ["smollm_135m", "llama32_vision_90b",
                                  "whisper_base"])
def test_synthetic_batches_equal_reference(arch):
    cfg = _cfg(arch)
    ref = RefSyntheticLM(ref_reduced_config(ref_get_config(arch)), 4, 16,
                         RefDataConfig(seed=3))
    got = SyntheticLM(cfg, 4, 16, DataConfig(seed=3))
    for step in (0, 42):
        want, have = ref.batch_at(step), got.batch_at(step)
        assert want.keys() == have.keys()
        for k in want:
            assert want[k].dtype == have[k].dtype, k
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert have["tokens"].max() < cfg.vocab


@pytest.mark.parametrize("arch", ["smollm_135m", "llama32_vision_90b"])
def test_ten_steps_match_reference_train_job(arch):
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    jc = dict(arch=arch, steps=10, batch=4, seq_len=32, lr=1e-3)
    ref = RefTrainJob(ref_cfg, RefTrainJobConfig(**jc), make_local_mesh())
    ref.initialize()
    job = TrainJob(_cfg(arch), TrainJobConfig(**jc), CPU)
    job.initialize()
    job.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, ref.params)))
    assert ref_cfg.optimizer == job.cfg.optimizer
    ref.run()
    job.run()
    np.testing.assert_allclose(job.history, ref.history, rtol=HISTORY_RTOL)
    assert job.history[-1] < job.history[0]


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(["--arch", "smollm_135m", "--reduced", "--steps",
                          "3", "--batch", "2", "--seq-len", "16",
                          "--checkpoint-dir", str(tmp_path), "--device",
                          "cpu"])
    assert out["completed"] and out["step"] == 3
    assert np.isfinite(out["loss"]) and np.isfinite(out["first_loss"])
    assert {"completed", "step", "loss", "wall_seconds",
            "first_loss"} <= set(out)
    assert '"first_loss"' in capsys.readouterr().out
    # resumes from the directory's checkpoint
    out = train_cli.main(["--arch", "smollm_135m", "--reduced", "--steps",
                          "5", "--batch", "2", "--seq-len", "16",
                          "--checkpoint-dir", str(tmp_path), "--device",
                          "cpu"])
    assert out["step"] == 5


def test_accumulated_job_runs():
    job = TrainJob(_cfg(), TrainJobConfig(
        arch="smollm_135m", steps=2, batch=4, seq_len=16, accum_steps=2),
        CPU)
    result = job.run()
    assert result["completed"] and all(np.isfinite(job.history))


def test_train_job_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TrainJob(_cfg(), TrainJobConfig(arch="smollm_135m"))
