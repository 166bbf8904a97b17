"""Live `simulate_flows` against the JAX engine on a 16-spine fabric, where
a reduction in another order than the reference's would show."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import sender as jsender  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro.net import transport as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.net import transport as tt  # noqa: E402

FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished",
          "link_served", "link_busy")
PAIRS = [(0, 1), (0, 2), (3, 1), (2, 3), (1, 0), (0, 3), (2, 1), (3, 0)]


@pytest.fixture(scope="module")
def fabric():
    """Eight flows on 4 leaves x 16 spines, congested (fractional capacity,
    tail drops, ECN) and degrading, so every float path is exercised."""
    topo = jtop.leaf_spine(4, 16, PAIRS, uplink_capacity=1.5, queue_limit=12.0,
                           ecn_threshold=4.0, degrade_p=0.02, recover_p=0.1)
    sched = jtop.null_schedule(topo.links)
    fields = ("route", "capacity", "queue_limit", "ecn_threshold", "latency",
              "degrade_p", "recover_p", "degrade_factor")
    ttopo = convert.topology_params({k: np.asarray(getattr(topo, k)) for k in fields},
                                    fb_delay=topo.fb_delay, ring_len=topo.ring_len)
    tsched = convert.event_schedule({"cap_scale": np.asarray(sched.cap_scale),
                                     "bg_arrivals": np.asarray(sched.bg_arrivals)})
    return topo, sched, ttopo, tsched


@pytest.mark.parametrize("early_exit", [False, True], ids=["full", "early-exit"])
@pytest.mark.parametrize("policy", ["WAM", "ECMP", "RAND_ADAPTIVE", "CC_COUPLED"])
def test_simulate_flows_matches_jax(fabric, policy, early_exit):
    coded = True
    topo, sched, ttopo, tsched = fabric
    cfg = jtr.TransportConfig(policy=jtr.Policy[policy], rate=32, coded=coded)
    # the reference's policy is traced: one compile per spec serves all four
    # policies (a block a policy does not read changes none of its bits)
    spec = jsender.SenderSpec(coded=coded, rate_cap=32, early_exit=early_exit,
                              state_blocks=("ccw",))
    with jax.threefry_partitionable(False):
        want = jsender.run_flows(topo, sched, spec, cfg.params(), 96,
                                 jax.random.PRNGKey(5), 384)
    pcfg = tt.TransportConfig(policy=tt.Policy[policy], rate=32, coded=coded,
                              early_exit=early_exit)
    got = tt.simulate_flows(ttopo, tsched, pcfg, 96, prng.PRNGKey(5), 384, device="cpu")
    for field in FIELDS:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), field
    assert bool(got.finished.all())
