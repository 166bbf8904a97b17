"""`tools/torch_trace_report.py` against `tools/trace_report.py`: the
reference's CLI cases (`tests/test_tools_cli.py`), plus a `--diff` of two
traces that differ and of two that agree, run through both tools on the
same files.  Standard output and exit codes must be equal (the help text
once each tool's own name and package are put back to the reference's),
and the port's error messages say what the reference's say."""
import contextlib
import importlib.util
import io
import json
import pathlib
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.net.telemetry import chrome_trace, write_series_jsonl  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _load("trace_report"), _load("torch_trace_report")


def _run(tool, argv):
    """(exit code, stdout, stderr) of ``tool.main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = tool.main(argv)
        except SystemExit as e:  # argparse: --help, usage errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _write_recovery_trace(path, policy, rates, onsets):
    """`test_tools_cli.py`'s per-policy recovery trace: a flat allocation
    and a cumulative `received` channel whose windowed rate at tick k is
    ``rates[k - 1]``."""
    total = np.concatenate([[0.0], np.cumsum(np.asarray(rates, np.float64))])
    ser = {"tick": np.arange(len(total), dtype=np.int64),
           "alloc": np.tile(np.asarray([3.0, 5.0]), (len(total), 1)),
           "received": total}
    write_series_jsonl(str(path), ser, meta={"policy": policy, "onsets": list(onsets),
                                             "tol": 0.0, "rate_frac": 0.8, "min_hold": 2})


def _queue_trace(path, bump):
    """A trace with queue, discrepancy and allocation channels; ``bump``
    raises one queue sample from tick 6 on."""
    rng = np.random.default_rng(3)
    q = rng.random((12, 4))
    q[6:, 2] += bump
    ser = {"tick": np.arange(0, 24, 2, dtype=np.int64), "link_queue": q,
           "disc": rng.random(12), "alloc": np.tile([4.0, 4.0], (12, 1))}
    write_series_jsonl(str(path), ser, meta={"name": "q", "onsets": [6], "tol": 1.0})
    return ser


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    f = {k: d / n for k, n in (("wam", "recovery_pair_WAM.jsonl"),
                               ("rr", "recovery_pair_RR.jsonl"), ("bare", "bare.jsonl"),
                               ("qa", "qa.jsonl"), ("qb", "qb.jsonl"), ("qc", "qc.jsonl"),
                               ("trace", "qa.trace.json"), ("bad", "bad.trace.json"),
                               ("dir", "not_a_trace.json"), ("missing", "missing.jsonl"))}
    _write_recovery_trace(f["wam"], "WAM", [10.0] * 9 + [2.0] * 5 + [10.0] * 10, [10])
    _write_recovery_trace(f["rr"], "RR", [10.0] * 9 + [2.0] * 16, [10])
    write_series_jsonl(str(f["bare"]), {"tick": np.arange(8, dtype=np.int64),
                                        "alloc": np.tile(np.asarray([1.0, 1.0]), (8, 1))},
                       meta={})
    ser = _queue_trace(f["qa"], 0.0)
    _queue_trace(f["qb"], 0.5)
    _queue_trace(f["qc"], 0.0)
    f["trace"].write_text(json.dumps(chrome_trace(ser, onsets=[6], max_links=2)))
    f["bad"].write_text(json.dumps({"traceEvents": [{"ph": "Q", "ts": 0, "name": "x"}]}))
    f["dir"].mkdir()
    return {k: str(v) for k, v in f.items()}


# (argv with file keys in braces, expected exit code, what stderr says)
CASES = {
    "summary": (["--summary", "{wam}", "{rr}"], 0, ""),
    "gate_censored": (["--summary", "--max-recovery-ticks", "100", "{wam}", "{rr}"], 1,
                      "RR: never re-converged"),
    "gate_pass": (["--summary", "--max-recovery-ticks", "100", "{wam}"], 0, ""),
    "gate_worst": (["--summary", "--max-recovery-ticks", "2", "{wam}"], 1, "worst recovery"),
    "gate_needs_meta": (["--summary", "--max-recovery-ticks", "10", "{bare}"], 2, "no trace"),
    "gate_summary_only": (["--check-perfetto", "--max-recovery-ticks", "10", "{bare}"], 2,
                          "only applies to --summary"),
    "summary_queues": (["--summary", "{qa}", "{qb}"], 0, ""),
    "unreadable_summary": (["--summary", "{missing}"], 2, "unreadable"),
    "unreadable_perfetto": (["--check-perfetto", "{dir}"], 2, "unreadable"),
    "perfetto": (["--check-perfetto", "{trace}"], 0, ""),
    "perfetto_invalid": (["--check-perfetto", "{trace}", "{bad}"], 1, ""),
    "diff_differ": (["--diff", "{qa}", "{qb}"], 1, ""),
    "diff_agree": (["--diff", "{qa}", "{qc}"], 0, ""),
    "diff_needs_two": (["--diff", "{qa}"], 2, "exactly two"),
}


@pytest.mark.parametrize("case", CASES)
def test_port_matches_reference(tools, files, case):
    argv, rc, says = CASES[case]
    argv = [a.format(**files) for a in argv]
    ref, port = (_run(tool, argv) for tool in tools)
    assert ref[0] == rc, ref
    assert port[:2] == ref[:2]
    assert says in port[2] and says in ref[2]
    assert "Traceback" not in port[2]


def test_help_matches_reference(tools):
    ref, port = (_run(tool, ["--help"]) for tool in tools)
    assert ref[0] == port[0] == 0 and "Exit:" in port[1]

    def own(text):
        return " ".join(re.sub(r"repro_torch\.net|torch_trace_report", lambda m: {
            "repro_torch.net": "repro.net"}.get(m.group(), "trace_report"), text).split())

    assert own(port[1]) == own(ref[1])
