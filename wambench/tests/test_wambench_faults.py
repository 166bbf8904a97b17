"""The check catches the faults a cell can have: the harness runs a tiny
cell on the CPU with the timed path broken underneath, and `correct`
comes out false."""
import pytest
from _wambench_tiny import tiny_cell

from repro_torch.net import sender
from wambench import run


def state_unchanged(monkeypatch):
    """The fabric's step hands back the state it was given."""
    real = sender.shared_fabric_tick

    def tick(topo, sched, state, *a, **k):
        _, fb = real(topo, sched, state, *a, **k)
        return state, fb

    monkeypatch.setattr(sender, "shared_fabric_tick", tick)


def half_the_flows(monkeypatch):
    """The second half of the flows' packets never enter the fabric."""
    real = sender.assign_paths

    def assign(*a, **k):
        arrivals, spray = real(*a, **k)
        arrivals = arrivals.clone()
        arrivals[arrivals.shape[0] // 2:] = 0.0
        return arrivals, spray

    monkeypatch.setattr(sender, "assign_paths", assign)


def one_decision_altered(monkeypatch):
    """One path decision, of one flow in the run's first tick, is wrong."""
    real, calls = sender.assign_lanes, []

    def lanes(policy, rate_cap, n, *a, **k):
        paths = real(policy, rate_cap, n, *a, **k)
        if not calls:
            paths = paths.clone()
            paths[0, 0] = (paths[0, 0] + 1) % n
        calls.append(1)
        return paths

    monkeypatch.setattr(sender, "assign_lanes", lanes)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_flows, one_decision_altered])
@pytest.mark.parametrize("name", ["fat_tree.perm_wam", "fat_tree.perm_ecmp"])
def test_fault_is_not_correct(name, fault, monkeypatch):
    class Broken(run.Program):
        def run(self, key, horizon=None):
            if horizon is not None:  # the set-up's warm-up stays sound
                return super().run(key, horizon)
            with pytest.MonkeyPatch.context() as mp:
                fault(mp)
                return super().run(key, horizon)

    result = run.run_cell(tiny_cell(name), 99, 0.0, False, "cpu", program_cls=Broken)
    assert result["correct"] is False and result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
