"""The port's in-scan telemetry against the JAX package: frames leaf for
leaf, capture as pure observation, decimation and early exit, the online
gauge against the integer oracle, the host-side metrics, and the JSONL /
Perfetto exports byte for byte."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import telemetry as jtel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core.deviation import spray_keys_np  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import telemetry as ttel  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402

HORIZON = 256
N_PACKETS = 96
RESULT_FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished",
                 "link_served", "link_busy")
# (name, scenario, policy, coded, TelemetrySpec kwargs): the reference
# suite's link_flap run, an ARQ run (debt moves), STrack's penalty channel
# on the two-path whack, and a run with every channel group off
RUNS = {
    "wam-link-flap": ("link_flap", "WAM", True, dict(stride=1, window=HORIZON)),
    "ecmp-arq-wrap": ("link_flap", "ECMP", False, dict(stride=3, window=8)),
    "strack-whack": ("whack", "STRACK", True, dict(stride=2, window=96)),
    "groups-off": ("link_flap", "WAM", True, dict(stride=1, window=HORIZON, paths=False,
                                                  links=False, discrepancy=False)),
}


def _scenario(name, mod):
    if name == "whack":
        return mod.two_path_whack(t_down=4, t_up=40, horizon=HORIZON)
    return mod.link_flap(flows=4, n_spines=4, period=32, horizon=HORIZON)


def _spec(mod, tmod, policy, coded, tel, early_exit=True):
    spec = mod.SenderSpec(rate_cap=8, coded=coded, early_exit=early_exit,
                          telemetry=None if tel is None else tmod.TelemetrySpec(**tel))
    return mod.spec_for_policies(spec, (mod.Policy[policy],))


def ref_run(name):
    scen, policy, coded, tel = RUNS[name]
    topo, sched = _scenario(scen, jscen)
    with jax.threefry_partitionable(False):
        return jsender.run_flows(topo, sched, _spec(jsender, jtel, policy, coded, tel),
                                 jsender.sender_params(jsender.Policy[policy], rate=8),
                                 N_PACKETS, jax.random.PRNGKey(0), HORIZON)


def port_run(name, *, tel="spec", early_exit=True):
    scen, policy, coded, tspec = RUNS[name]
    topo, sched = _scenario(scen, tscen)
    if tel != "spec":
        tspec = None if tel is None else dataclasses.asdict(tel)
    spec = _spec(tsender, ttel, policy, coded, tspec, early_exit)
    return tsender.run_flows(topo, sched, spec,
                             tsender.sender_params(tsender.Policy[policy], rate=8),
                             N_PACKETS, prng.PRNGKey(0), HORIZON, device="cpu")


@pytest.fixture(scope="module")
def dense():
    """The link_flap WAM run with dense capture, the reference's and the
    port's."""
    return ref_run("wam-link-flap"), port_run("wam-link-flap")


def ref_frame(frame):
    return convert.telemetry_frame({f.name: np.asarray(getattr(frame, f.name))
                                    for f in dataclasses.fields(frame)})


def assert_frames_equal(want, got):
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert w.dtype == g.dtype and w.shape == g.shape, f.name
        assert torch.equal(w, g), f.name


@pytest.mark.parametrize("name", list(RUNS))
def test_frame_matches_reference(name, dense):
    (want_r, want_f), (got_r, got_f) = dense if name == "wam-link-flap" else (
        ref_run(name), port_run(name))
    assert_frames_equal(ref_frame(want_f), got_f)
    for field in RESULT_FIELDS:
        assert np.array_equal(np.asarray(getattr(want_r, field)),
                              getattr(got_r, field).numpy()), field
    if name == "ecmp-arq-wrap":
        assert int(got_f.count) > got_f.window  # the ring wrapped
        assert float(got_f.debt.max()) > 0
    if name == "strack-whack":
        assert got_f.pstate_pen.shape[-1] == 2 and float(got_f.pstate_pen.max()) > 0


def test_enabled_capture_is_bit_identical_to_disabled(dense):
    _, (result, _) = dense
    bare = port_run("wam-link-flap", tel=None)
    assert not isinstance(bare, tuple)
    for f in dataclasses.fields(bare):
        assert torch.equal(getattr(result, f.name), getattr(bare, f.name)), f.name


def test_decimated_equals_dense_subsampled(dense):
    _, (_, dense_frame) = dense
    full = ttel.series(ttel.frame_select(dense_frame, ()))
    _, dec_frame = port_run("wam-link-flap", tel=ttel.TelemetrySpec(stride=4, window=64))
    dec = ttel.series(ttel.frame_select(dec_frame, ()))
    keep = full["tick"] % 4 == 0
    assert np.array_equal(dec["tick"], full["tick"][keep])
    for name in dec:
        if name not in ("tick", "disc"):  # the gauge's window is the stride
            assert np.array_equal(dec[name], full[name][keep]), name


def test_early_exit_capture_equals_full_horizon(dense):
    _, (fast_r, fast_frame) = dense
    full_r, full_frame = port_run("wam-link-flap", early_exit=False)
    assert int(fast_r.ticks_run) < int(full_r.ticks_run) == HORIZON
    assert_frames_equal(fast_frame, full_frame)


def test_discrepancy_gauge_matches_integer_oracle():
    """A static fabric and a non-integral share (1024 / 3): the gauge is
    nonzero and equals the §9 oracle over every capture window."""
    topo = ttop.leaf_spine(2, 3, [(0, 1), (1, 0)])
    sched = ttop.null_schedule(topo.links, 8)
    spec = tsender.SenderSpec(rate_cap=5, early_exit=True,
                              telemetry=ttel.TelemetrySpec(stride=3, window=128))
    _, frame = tsender.run_flows(topo, sched, spec, tsender.sender_params(
        tsender.Policy.WAM, rate=5), 64, prng.PRNGKey(1), 512, device="cpu")
    ser = ttel.series(frame)
    m = 1 << spec.ell
    mask = m - 1
    assert float(np.max(ser["disc"])) > 0.0
    checked = 0
    for f in range(topo.flows):
        sa, sb = (333 + f * 0x9E3779B9) & mask, ((735 + 2 * f) & mask) | 1
        prev_sent, prev_j = np.zeros(topo.n), 0
        for k in range(len(ser["tick"])):
            b = ser["alloc"][k, f].astype(np.int64)
            c = np.concatenate([[0], np.cumsum(b)])
            x = int(ser["emitted"][k, f]) - prev_j
            keys = spray_keys_np(spec.ell, int(spec.method), sa, sb, prev_j, x)
            hits = np.array([((keys >= c[i]) & (keys < c[i + 1])).sum()
                             for i in range(topo.n)])
            assert np.array_equal(ser["sent_pp"][k, f] - prev_sent, hits)
            assert float(ser["disc"][k, f]) == np.max(np.abs(m * hits - b * x)) / m
            prev_sent, prev_j = ser["sent_pp"][k, f], int(ser["emitted"][k, f])
            checked += 1
    assert checked > 10


def test_run_message_frame_matches_reference():
    """The single-flow engine on the independent-bundle fabric (no links):
    the frame loses the flow axis like the reference's."""
    from repro.net import fabric as jfab

    import jax.numpy as jnp
    n = 4
    jp = jfab.FabricParams(capacity=jnp.full((n,), 3.0), latency=jnp.full((n,), 4, jnp.int32),
                           queue_limit=jnp.full((n,), 12.0), ecn_threshold=jnp.full((n,), 5.0),
                           degrade_p=jnp.full((n,), 0.03), recover_p=jnp.full((n,), 0.1),
                           degrade_factor=jnp.full((n,), 0.2), fb_delay=8, ring_len=64)
    tel = dict(stride=2, window=64)
    spec = jsender.SenderSpec(rate_cap=8, telemetry=jtel.TelemetrySpec(**tel))
    with jax.threefry_partitionable(False):
        want_r, want_f = jsender.run_message(jp, spec, jsender.sender_params(
            jsender.Policy.WAM, rate=8), 128, jax.random.PRNGKey(4), 256)
    tp = convert.fabric_params({k: np.asarray(getattr(jp, k)) for k in (
        "capacity", "latency", "queue_limit", "ecn_threshold", "degrade_p", "recover_p",
        "degrade_factor")}, fb_delay=8, ring_len=64)
    got_r, got_f = tsender.run_message(
        tp, tsender.SenderSpec(rate_cap=8, telemetry=ttel.TelemetrySpec(**tel)),
        tsender.sender_params(tsender.Policy.WAM, rate=8), 128, prng.PRNGKey(4), 256,
        device="cpu")
    assert_frames_equal(ref_frame(want_f), got_f)
    for field in RESULT_FIELDS[:6]:
        assert np.array_equal(np.asarray(getattr(want_r, field)), getattr(got_r, field).numpy())


def test_host_metrics_match_reference(dense):
    """Every host-side metric on the same arrays: the run's series and the
    schedules of the scenario library."""
    (_, want_f), (_, got_f) = dense
    want, got = jtel.series(jtel.frame_select(want_f, ())), ttel.series(got_f)
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    for scen_j, scen_t in zip(jscen.pair_scenarios(flows=4, horizon=HORIZON).values(),
                              tscen.pair_scenarios(flows=4, horizon=HORIZON).values()):
        for fn in ("event_onsets", "degrade_onsets", "restore_onsets"):
            assert np.array_equal(getattr(jtel, fn)(scen_j[1]), getattr(ttel, fn)(scen_t[1]))
    onsets = ttel.event_onsets(tscen.link_flap(flows=4, n_spines=4, period=32,
                                               horizon=HORIZON)[1])
    for window in (0, 4, 40):
        assert np.array_equal(jtel.merge_onsets(onsets, window),
                              ttel.merge_onsets(onsets, window))
    for tol, hold in ((0.0, 2), (64.0, 1), (16.0, 4)):
        a = jtel.recovery_ticks(got["tick"], got["alloc"], onsets, tol=tol, min_hold=hold)
        b = ttel.recovery_ticks(got["tick"], got["alloc"], onsets, tol=tol, min_hold=hold)
        assert np.array_equal(a, b)
        assert jtel.summarize_recovery(a) == ttel.summarize_recovery(b)
    for frac, hold in ((0.8, 2), (0.5, 1)):
        assert np.array_equal(
            jtel.rate_recovery_ticks(got["tick"], got["received"], onsets, frac=frac,
                                     min_hold=hold),
            ttel.rate_recovery_ticks(got["tick"], got["received"], onsets, frac=frac,
                                     min_hold=hold))
    for before, after, window in ((64, None, 8), (40, 100, 4)):
        assert jtel.profile_distance(got["tick"], got["alloc"], before=before, after=after,
                                     window=window) == ttel.profile_distance(
            got["tick"], got["alloc"], before=before, after=after, window=window)
    assert jtel.queue_percentiles(got) == ttel.queue_percentiles(got)
    assert jtel.queue_percentiles(got, (10.0, 90.0)) == ttel.queue_percentiles(got, (10.0, 90.0))


def test_exports_are_byte_equal_to_reference(tmp_path, dense):
    (_, want_f), (_, got_f) = dense
    want, got = jtel.series(jtel.frame_select(want_f, ())), ttel.series(got_f)
    onsets = [int(t) for t in ttel.event_onsets(
        tscen.link_flap(flows=4, n_spines=4, period=32, horizon=HORIZON)[1])]
    meta = {"onsets": onsets, "policy": "WAM"}
    jtel.write_series_jsonl(str(tmp_path / "ref.jsonl"), want, meta=meta)
    ttel.write_series_jsonl(str(tmp_path / "port.jsonl"), got, meta=meta)
    assert (tmp_path / "ref.jsonl").read_bytes() == (tmp_path / "port.jsonl").read_bytes()
    back, back_meta = jtel.read_series_jsonl(str(tmp_path / "port.jsonl"))
    assert back_meta == meta and list(back) == list(got)
    for k in got:
        assert np.array_equal(back[k], got[k]), k
    mine, _ = ttel.read_series_jsonl(str(tmp_path / "port.jsonl"))
    for k in got:
        assert mine[k].dtype == back[k].dtype and np.array_equal(mine[k], back[k]), k
    for kw in (dict(onsets=onsets, flow=0, max_links=2), dict(flow=3), dict()):
        assert json.dumps(jtel.chrome_trace(want, **kw)) == json.dumps(
            ttel.chrome_trace(got, **kw))


def test_frame_select_and_series_refuse_sweep_axes(dense):
    _, (_, frame) = dense
    stacked = dataclasses.replace(frame, **{f.name: torch.stack([getattr(frame, f.name)] * 2)
                                            for f in dataclasses.fields(frame)})
    with pytest.raises(ValueError, match="frame_select"):
        ttel.series(stacked)
    assert_frames_equal(frame, ttel.frame_select(stacked, 1))
    with pytest.raises(ValueError):
        ttel.TelemetrySpec(stride=0)
    with pytest.raises(ValueError):
        ttel.TelemetrySpec(window=0)
    assert ttel.TelemetrySpec(stride=4, window=8).samples(64) == 16
