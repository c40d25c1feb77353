"""The faults a cell of the ``tick_study`` driver kind can have, planted in
the program underneath a CPU run (``test_portbench_control.py``): a
substep that leaves every job's state as it found it (nothing ever
starts), half of a fortnight's lanes left out (their rows copied from the
other half), an answer altered where it is produced (every lane's
completed jobs + 1) and a synthesized table altered (runtimes x 1.001).
One chip: no exchange to leave out.

``FAULTS`` maps each fault's name to ``patch(monkeypatch)``."""

import torch


def _step_unchanged(monkeypatch):
    from repro_torch.kernels import jaxsim_step
    monkeypatch.setattr(jaxsim_step, "first_fit",
                        lambda queued, size, free: torch.zeros_like(queued))


def _half_left_out(monkeypatch):
    from repro_torch.core import jaxsim
    orig = jaxsim.simulate

    def half(params, *args, **kwargs):
        out = orig(params, *args, **kwargs)
        n = next(iter(out.values())).shape[0]
        keep = torch.arange(n) % max(n // 2, 1)
        return {k: v[keep.to(v.device)] for k, v in out.items()}

    monkeypatch.setattr(jaxsim, "simulate", half)


def _answer_altered(monkeypatch):
    from repro_torch.core import jaxsim
    orig = jaxsim.simulate

    def altered(params, *args, **kwargs):
        out = dict(orig(params, *args, **kwargs))
        out["completed_jobs"] = out["completed_jobs"] + 1
        return out

    monkeypatch.setattr(jaxsim, "simulate", altered)


def _table_altered(monkeypatch):
    from repro_torch.sim import scenarios
    orig = scenarios._pbj_from_draws

    def altered(*args, **kwargs):
        submit, size, runtime, n = orig(*args, **kwargs)
        return submit, size, runtime * 1.001, n

    monkeypatch.setattr(scenarios, "_pbj_from_draws", altered)


FAULTS = {"step_unchanged": _step_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "table_altered": _table_altered}
