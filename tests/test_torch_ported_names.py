"""Names of the JAX package's modules that the port's copies of those
modules now carry too (`AdmissionController.offer`, `mock.gpu_node`,
`_Summary.percentile`, `feasible.check_affinity`), against the
reference's, on the CPU."""
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import feasible as ref_feasible
from nomad_tpu.server.serving import AdmissionController as RefAdmission
from nomad_tpu.utils.metrics import _Summary as RefSummary
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import feasible as port_feasible
from nomad_tpu_torch.server.serving import AdmissionController
from nomad_tpu_torch.utils.metrics import _Summary


def test_admission_offer_is_offer_ex_verdict():
    """`offer` admits or sheds as `offer_ex` does, and as the
    reference's `offer` on the same arrivals."""
    out = {}
    for name, (Adm, mock) in {"ref": (RefAdmission, ref_mock),
                              "port": (AdmissionController,
                                       port_mock)}.items():
        adm, twin = Adm(max_pending=4), Adm(max_pending=4)
        got = []
        for k, prio in enumerate((50, 50, 10, 90, 50, 10)):
            ev = mock.eval_(job_id=f"job-{k}", priority=prio)
            verdict = adm.offer(ev, ready_count=k)
            assert verdict == twin.offer_ex(ev, ready_count=k)[0]
            got.append(verdict)
        out[name] = got
    assert out["port"] == out["ref"]
    assert True in out["port"] and False in out["port"]


def test_gpu_node_matches_reference():
    p, r = port_mock.gpu_node(n_gpus=3), ref_mock.gpu_node(n_gpus=3)
    (pd,), (rd,) = p.node_resources.devices, r.node_resources.devices
    assert (pd.vendor, pd.type, pd.name, pd.attributes) == \
        (rd.vendor, rd.type, rd.name, rd.attributes)
    assert len(pd.instances) == len(rd.instances) == 3
    assert all(i.healthy for i in pd.instances)
    assert p.computed_class and p.computed_class != port_mock.node().computed_class


@pytest.mark.parametrize("p", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_summary_percentile_matches_reference(p):
    port, ref = _Summary(), RefSummary()
    assert port.percentile(p) == ref.percentile(p) == 0.0
    for v in (5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0):
        port.add(v)
        ref.add(v)
    assert port.percentile(p) == ref.percentile(p)


@pytest.mark.parametrize("operand,lval,rval,lfound", [
    ("=", "linux", "linux", True), ("!=", "linux", "windows", True),
    ("!=", None, "x", False), ("<", "a", "b", True),
    ("regexp", "r12", "r1[0-9]", True), ("version", "1.2.0", ">= 1.1", True),
    ("is_set", "v", None, True), ("is_not_set", None, None, False),
])
def test_check_affinity_matches_reference(operand, lval, rval, lfound):
    args = (operand, lval, rval, lfound, rval is not None)
    assert port_feasible.check_affinity(*args) == \
        ref_feasible.check_affinity(*args) == \
        port_feasible.check_constraint(*args)
