"""The control, the reference scored in bfloat16 in the program's
place, comes out not correct."""
import pytest

from benchmark.tests import _small


@pytest.mark.parametrize("workload,number", [
    ("c2-stream", "choice_mismatch"), ("c3-server-burst", "score_gap")])
def test_the_bf16_control_is_not_correct(workload, number):
    r = _small.run(workload, seconds=2.0, control="bf16")
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]
