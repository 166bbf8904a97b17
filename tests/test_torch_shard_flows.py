"""The port's flow-sharded engines on the CPU, against the JAX package's
unsharded engines.

Ranks are threads with private gloo groups (`repro_torch.ranks`,
``flow_mesh(n, device="cpu")``).  Every field of every sharded result is
bit-equal to the reference's jitted unsharded run (whose own tests show
its sharded and unsharded runs are bit-identical), and ``ticks_run`` to
the port's unsharded run: one rank, two and three ranks over five flows
with a size-0 flow (padded), the pair family and a seven-flow fat-tree
family at two ranks, `shard_sweep_flows`; then the refusals, a failing
rank, many ranks on few cores, and what a call leaves behind.  Reference
calls run inside ``jax.threefry_partitionable(False)``, once per module."""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import ranks  # noqa: E402
from repro_torch.kernels import count_launch  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import telemetry as ttel  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402

RATE = 16
FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished",
          "link_served", "link_busy")
PAIRS = [(0, 2), (1, 3), (2, 1), (0, 3), (3, 0)]
SIZES = [48, 0, 24, 64, 16]
POLICIES = ("ECMP", "WAM")


def _spec(mod):
    return mod.SenderSpec(rate_cap=RATE, early_exit=True, exit_chunk=16)


def _keys(seed, n):
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, convert.prng_key(np.asarray(keys))


def _mesh(n):
    # a healthy rank waits a tick of the others at most: a hung one fails its
    # test within the minute
    return tsender.flow_mesh(n, device="cpu", timeout=60)


def _equal(want, got, what):
    """Every reference field of ``want`` equal, dtype, shape and bits."""
    for name in FIELDS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, (what, name, w.dtype, g.dtype)
        assert np.array_equal(w, g), (what, name)


def _family(name, scen, top):
    if name == "pair":
        scens = scen.pair_scenarios(4, 2, horizon=256)
        return scen.stack_scenarios([scens[k] for k in list(scens)[:2]])
    return scen.stack_scenarios(list(scen.fat_tree_scenarios(flows=7, n_pods=2,
                                                             horizon=512).values()))


@pytest.fixture(scope="module")
def padded():
    """Five flows, one of size 0, on a 4-leaf fabric: the reference's
    `run_flows_sized` and the port's unsharded run."""
    jkey, tkey = _keys(4, 1)
    topo = jtop.leaf_spine(4, 2, PAIRS)
    sp = jsender.sender_params(jsender.Policy.WAM, rate=RATE)
    with jax.threefry_partitionable(False):
        want = jsender.run_flows_sized(topo, jtop.null_schedule(topo.links), _spec(jsender), sp,
                                       np.asarray(SIZES, np.int32), jkey[0], 512)
    ttopo = ttop.leaf_spine(4, 2, PAIRS)
    args = (ttopo, ttop.null_schedule(ttopo.links), _spec(tsender),
            tsender.sender_params(tsender.Policy.WAM, rate=RATE),
            torch.tensor(SIZES, dtype=torch.int32), tkey[0], 512)
    return want, args, tsender.run_flows_sized(*args, device="cpu")


@pytest.fixture(scope="module")
def families():
    """The pair family (two scenarios, two draws, 32 packets, horizon 256)
    and the seven-flow fat-tree family (four scenarios, one draw, 16
    packets, horizon 512), ECMP and WAM: the reference's unsharded sweeps
    and the port's two-rank sharded ones."""
    out = {}
    for name, n_packets, horizon, draws in (("pair", 32, 256, 2), ("fat_tree", 16, 512, 1)):
        jkeys, tkeys = _keys(5, draws)
        sp = jsender.policy_sweep_params([jsender.Policy[p] for p in POLICIES], rate=RATE)
        with jax.threefry_partitionable(False):
            want = jsender.sweep_flows_scenarios(*_family(name, jscen, jtop), _spec(jsender), sp,
                                                 n_packets, jkeys, horizon)
        tsp = tsender.policy_sweep_params([tsender.Policy[p] for p in POLICIES], rate=RATE)
        topos, scheds = _family(name, tscen, ttop)
        got = tsender.shard_sweep_flows_scenarios(topos, scheds, _spec(tsender), tsp, n_packets,
                                                  tkeys, horizon, mesh=_mesh(2))
        out[name] = dict(want=want, got=got, topos=topos, scheds=scheds, sp=tsp, keys=tkeys,
                         n_packets=n_packets, horizon=horizon)
    return out


def test_shard_run_flows_one_rank_equals_reference():
    jkey, tkey = _keys(3, 1)
    pairs = PAIRS[:4]
    topo = jtop.leaf_spine(4, 2, pairs)
    with jax.threefry_partitionable(False):
        want = jsender.run_flows(topo, jtop.null_schedule(topo.links), _spec(jsender),
                                 jsender.sender_params(jsender.Policy.WAM, rate=RATE), 48,
                                 jkey[0], 512)
    ttopo = ttop.leaf_spine(4, 2, pairs)
    args = (ttopo, ttop.null_schedule(ttopo.links), _spec(tsender),
            tsender.sender_params(tsender.Policy.WAM, rate=RATE), 48, tkey[0], 512)
    got = tsender.shard_run_flows(*args, mesh=_mesh(1))
    _equal(want, got, "one rank")
    assert int(got.ticks_run) == int(tsender.run_flows(*args, device="cpu").ticks_run)


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_padded_ranks_equal_run_flows_sized(padded, n_ranks):
    """Five flows over 2 and 3 ranks (padded to 6): every field equal to
    `run_flows_sized`, the size-0 flow silent."""
    want, args, unsharded = padded
    got = tsender.shard_run_flows(*args, mesh=_mesh(n_ranks))
    _equal(want, got, n_ranks)
    assert got.ticks_run.dtype == torch.int64 and torch.equal(got.ticks_run, unsharded.ticks_run)
    assert float(got.cct[1]) == 0.0 and not bool(got.sent_total[1].any())


@pytest.mark.parametrize("name", ["pair", "fat_tree"])
def test_shard_sweep_flows_scenarios_equals_reference(families, name):
    """The pair family and the seven-flow fat-tree family (flows the two
    ranks do not divide) sharded over two ranks: every field of ``[C, P,
    D, F]`` equal to the reference's unsharded family sweep."""
    fam = families[name]
    _equal(fam["want"], fam["got"], name)
    C, D = int(fam["topos"].route.shape[0]), int(fam["keys"].shape[0])
    assert tuple(fam["got"].ticks_run.shape) == (C, len(POLICIES), D)
    if name == "fat_tree":
        unsharded = tsender.sweep_flows_scenarios(
            fam["topos"], fam["scheds"], _spec(tsender), fam["sp"], fam["n_packets"],
            fam["keys"], fam["horizon"], device="cpu")
        assert torch.equal(fam["got"].ticks_run, unsharded.ticks_run)


def test_shard_sweep_flows_equals_the_scenario_slice(families):
    """`shard_sweep_flows` on the pair family's second scenario, at three
    ranks: the reference sweep's slice (scenario c of a family sweep is
    `sweep_flows` on it)."""
    fam = families["pair"]
    topo, sched = (ttel.frame_select(x, 1) for x in (fam["topos"], fam["scheds"]))
    got = tsender.shard_sweep_flows(topo, sched, _spec(tsender), fam["sp"], fam["n_packets"],
                                    fam["keys"], fam["horizon"], mesh=_mesh(3))
    want = jax.tree.map(lambda x: np.asarray(x)[1], fam["want"])
    _equal(want, got, "shard_sweep_flows")
    assert torch.equal(got.ticks_run, fam["got"].ticks_run[1])


def test_sharded_path_refuses_telemetry(padded):
    _, args, _ = padded
    spec = dataclasses.replace(args[2], telemetry=ttel.TelemetrySpec(stride=4, window=8))
    with pytest.raises(NotImplementedError, match="telemetry"):
        tsender.shard_run_flows(*args[:2], spec, *args[3:], mesh=_mesh(2))


def test_flow_mesh_ranks_and_backends():
    mesh = _mesh(3)
    assert mesh.size == 3 and mesh.backend == "gloo"
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert _mesh(None).size == 1
    with pytest.raises(ValueError):
        _mesh(0)


def test_failing_rank_reaches_the_caller_at_once():
    """Rank 1 raises while rank 0 waits in a collective: the caller gets
    rank 1's error well inside the group's timeout (the failing rank closes
    its group, so rank 0's gather fails at once), and no thread is left."""
    mesh = tsender.flow_mesh(2, device="cpu", timeout=20)

    def body(comm):
        if comm.rank == 1:
            raise ValueError("rank 1 fails")
        return comm.all_gather(torch.ones(3), 0)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 fails") as info:
        ranks.run_ranks(mesh, body)
    assert time.monotonic() - t0 < 10
    assert any("flow rank 1 of 2" in note for note in info.value.__notes__)
    assert not [t for t in threading.enumerate() if t.name.startswith("flow-rank-")]


def test_hanging_rank_fails_within_the_groups_timeout():
    """Rank 1 stalls past the group's timeout of 1 s while rank 0 waits for
    it: rank 0's wait times out, and the caller is told that rank 1 still
    runs a timeout later, within seconds, not when rank 1 comes back (which
    then ends its thread)."""
    mesh = tsender.flow_mesh(2, device="cpu", timeout=1)

    def body(comm):
        if comm.rank == 1:
            time.sleep(4)
        return comm.all_gather(torch.ones(3), 0)

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="flow-rank-1 still runs") as info:
        ranks.run_ranks(mesh, body)
    assert time.monotonic() - t0 < 4
    # rank 0's wait timed out: in its collective, or for its turn if rank 1
    # took the first one
    assert isinstance(info.value.__cause__, (RuntimeError, TimeoutError))
    assert "rank 0" in str(info.value)
    alive = [t for t in threading.enumerate() if t.name.startswith("flow-rank-")]
    for t in alive:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in alive)


def test_many_ranks_on_few_cores_lose_nothing():
    """More ranks than cores, with a short switch interval: every gather
    holds every rank's values in rank order, and no launch count is lost."""
    n_ranks, rounds, counts = max(12, (os.cpu_count() or 1) + 4), 20, 2000

    def counted():
        pass

    counted.launches = 0

    def body(comm):
        seen = []
        for i in range(rounds):
            seen.append(comm.all_gather(torch.tensor([comm.rank, i]), 0))
            for _ in range(counts // rounds):
                count_launch(counted)
        return seen

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = ranks.run_ranks(tsender.flow_mesh(n_ranks, device="cpu", timeout=60), body)
    finally:
        sys.setswitchinterval(interval)
    for seen in out:
        for i, g in enumerate(seen):
            assert g.tolist() == [x for r in range(n_ranks) for x in (r, i)]
    assert counted.launches == n_ranks * counts


def test_a_sharded_call_leaves_no_process_state(padded):
    """No default process group, the same environment and no rank thread
    after a call, as before it."""
    _, args, _ = padded
    env = dict(os.environ)
    assert not torch.distributed.is_initialized()
    tsender.shard_run_flows(*args, mesh=_mesh(2))
    assert not torch.distributed.is_initialized()
    assert dict(os.environ) == env
    assert not [t for t in threading.enumerate() if t.name.startswith("flow-rank-")]
