"""Faults planted under the timed path, to show that the comparison
catches them (``tests/test_bench_faults.py`` on the CPU, ``control.py
--fault`` on the card).  Each ``plant(name, patch)`` replaces port methods
through ``patch(owner, attribute, value)`` (pytest's ``monkeypatch.setattr``
or ``Patcher.setattr``):

* ``state_unchanged``: every Newton solve returns its start (no step, no
  FD polish); the init sweeps run as they are;
* ``start_returned``: every scale's solve returns its start: the init
  sweeps keep their start motion too;
* ``half_events``: every second event of each window left out of the
  solve;
* ``half_frames``: a fleet batch solves its first half and returns those
  answers for the second half too;
* ``altered_motion``: the returned finest motion moved by 10 px/s on one
  tile;
* ``altered_aee``: the AEE the eval loop reports raised by 0.01 px.
"""

NAMES = ("state_unchanged", "start_returned", "half_events", "half_frames", "altered_motion", "altered_aee")


def _classes():
    from event_based_optical_flow_tpu_torch.solver import base, fleet, patch_base, pyramid

    return base.SolverBase, patch_base.PatchContrastMaximization, pyramid.PyramidalPatchContrastMaximization, \
        fleet.FleetPyramidalSolver


def plant(name: str, patch) -> None:
    base, patch_cls, seq, fleet = _classes()
    if name in ("state_unchanged", "start_returned"):
        run_newton, run_fleet = patch_cls._run_newton, fleet._run_fleet_newton

        def no_step(solve):
            def newton(self, spec, x0, frames, orig, maxiter, *args, **kw):
                polish = self.opt_config.get("fd_polish", 0)
                self.opt_config["fd_polish"] = 0
                try:
                    return solve(self, spec, x0, frames, orig, 0, *args, **kw)
                finally:
                    self.opt_config["fd_polish"] = polish
            return newton

        patch(patch_cls, "_run_newton", no_step(run_newton))
        patch(fleet, "_run_fleet_newton", no_step(run_fleet))
        if name == "start_returned":
            patch(patch_cls, "initialize_guess_from_patch_search",
                  lambda self, events, motion0, n_candidates: motion0.reshape(2, -1))
            patch(patch_cls, "initialize_guess_from_patch_search_batched",
                  lambda self, events_list, motion0, n_candidates, max_events: motion0)
    elif name == "half_events":
        optimize, optimize_batch = seq.optimize, fleet.optimize_batch
        patch(seq, "optimize", lambda self, events: optimize(self, events[::2]))
        patch(fleet, "optimize_batch", lambda self, events: optimize_batch(self, [e[::2] for e in events]))
    elif name == "half_frames":
        optimize_batch = fleet.optimize_batch
        patch(fleet, "optimize_batch",
              lambda self, events: (optimize_batch(self, events[: len(events) // 2]) * 2)[: len(events)])
    elif name == "altered_motion":
        optimize, optimize_batch = seq.optimize, fleet.optimize_batch

        def alter(result):
            finest = max(result)
            result = dict(result)
            result[finest] = result[finest].clone()
            result[finest][0, 0, 0] += 10.0
            return result

        patch(seq, "optimize", lambda self, events: alter(optimize(self, events)))
        patch(fleet, "optimize_batch", lambda self, events: [alter(r) for r in optimize_batch(self, events)])
    elif name == "altered_aee":
        flow_error = base.calculate_flow_error

        def altered(self, *args, **kw):
            out = flow_error(self, *args, **kw)
            out["EPE"] += 0.01
            return out

        patch(base, "calculate_flow_error", altered)
    else:
        raise ValueError(f"no fault {name!r}; one of {NAMES}")


class Patcher:
    """``setattr`` that ``undo`` reverts (for a run outside pytest)."""

    def __init__(self):
        self._saved = []

    def setattr(self, owner, name, value) -> None:
        self._saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)
