"""The port's cost model (`repro_torch.analysis.costs`) against the JAX
package's, for every arch and shape: parameter counts and bytes, FLOP
counts, memory traffic, the job layer's communication terms and the
roofline terms, equal as Python floats (the same float64 arithmetic)."""
import pytest

from repro.analysis import costs as jcosts
from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro_torch.analysis import costs as tcosts
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry


def _pair(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    return getattr(jregistry, get)(arch), getattr(tregistry, get)(arch)


def test_exports_resolve():
    """Every name the port exports exists (the reference's ``__all__``
    lists a ``decode_flops`` it never defines; the port leaves it out)."""
    for name in tcosts.__all__:
        assert hasattr(tcosts, name), name
    assert set(tcosts.__all__) == (set(jcosts.__all__) - {"decode_flops"}) | {"hbm_bytes"}


def test_simulated_cluster_constants_equal_reference():
    assert (tcosts.PEAK_FLOPS, tcosts.HBM_BW, tcosts.ICI_BW) == (
        jcosts.PEAK_FLOPS, jcosts.HBM_BW, jcosts.ICI_BW)
    assert tcosts.HW == jcosts.HW


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_cost_model_equals_reference(arch, smoke):
    jcfg, tcfg = _pair(arch, smoke)
    assert tcosts.param_count(tcfg) == jcosts.param_count(jcfg)
    assert tcosts.param_bytes(tcfg) == jcosts.param_bytes(jcfg)
    for seq, kv in ((4096, None), (1, 32768), (128, 7)):
        assert tcosts.fwd_flops_per_token(tcfg, seq, kv) == jcosts.fwd_flops_per_token(
            jcfg, seq, kv)
    for name in jbase.SHAPES:
        jshape, tshape = jbase.SHAPES[name], tbase.SHAPES[name]
        assert tcosts.model_flops(tcfg, tshape) == jcosts.model_flops(jcfg, jshape)
        assert tcosts.train_flops(tcfg, tshape) == jcosts.train_flops(jcfg, jshape)
        for chips in (1, 8, 256):
            assert tcosts.hbm_bytes(tcfg, tshape, chips) == jcosts.hbm_bytes(jcfg, jshape, chips)
            for kw in (dict(), dict(measured_flops=3e15, collective_bytes_per_dev=2e9)):
                assert tcosts.roofline_terms(tcfg, tshape, chips, **kw) == \
                    jcosts.roofline_terms(jcfg, jshape, chips, **kw)


@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_job_comm_terms_equal_reference(arch):
    jcfg, tcfg = _pair(arch, False)
    for workers, tp in ((4, 8), (2, 1), (16, 4)):
        jshape = jbase.ShapeSpec("train_micro", 4096, workers, "train")
        tshape = tbase.ShapeSpec("train_micro", 4096, workers, "train")
        assert tcosts.job_comm_terms(tcfg, tshape, dp=workers, tp=tp) == \
            jcosts.job_comm_terms(jcfg, jshape, dp=workers, tp=tp)
    with pytest.raises(ValueError, match="dp >= 2"):
        tcosts.job_comm_terms(tcfg, tbase.SHAPES["train_4k"], dp=1, tp=8)
