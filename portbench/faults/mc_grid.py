"""The faults a cell of the ``mc_grid`` driver kind can have, planted in
the program underneath a CPU run (``test_portbench_control.py``): a
round step that returns its state unchanged, half of a query's lanes
left out (their rows copied from the other half), an answer altered
where it is produced (every lane's completed jobs + 1) and a
synthesized table altered (runtimes x 1.001). One chip: no exchange to
leave out.

``FAULTS`` maps each fault's name to ``patch(monkeypatch)``."""

import torch


def _step_unchanged(monkeypatch):
    from repro_torch.kernels import round_step as rsk
    monkeypatch.setattr(rsk, "chunk_step_ref",
                        lambda jobs, rises, wstab, prm, sc, win, **kw:
                        (sc.clone(), win.clone()))


def _half_left_out(monkeypatch):
    from repro_torch.sim import rounds
    orig = rounds._simulate_rounds

    def half(policy, prm, pk, spec):
        out = orig(policy, prm, pk, spec)
        n = next(iter(out.values())).shape[0]
        keep = torch.arange(n) % max(n // 2, 1)
        return {k: v[keep] for k, v in out.items()}

    monkeypatch.setattr(rounds, "_simulate_rounds", half)


def _answer_altered(monkeypatch):
    from repro_torch.sim import rounds
    orig = rounds._simulate_rounds

    def altered(policy, prm, pk, spec):
        out = dict(orig(policy, prm, pk, spec))
        out["completed_jobs"] = out["completed_jobs"] + 1
        return out

    monkeypatch.setattr(rounds, "_simulate_rounds", altered)


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
