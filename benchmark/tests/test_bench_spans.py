"""The reader of the program's own counters: a traced run reports
syncs_per_wave.stream, and a program without the counters gives
nothing to read, without an error."""
from benchmark import harness
from benchmark.tests import _small


def test_traced_stream_run_reports_syncs_per_wave():
    r = _small.run("c2-stream", trace=1, seconds=0.5)
    m = r["metrics"]["syncs_per_wave.stream"]
    assert m["unit"] == "syncs"
    # the loop's entry test and the rotation seed's copy a wave, at least
    assert 1.0 < m["value"] < 10.0


def test_nothing_to_read_without_the_counters(monkeypatch):
    from nomad_tpu_torch.utils.metrics import global_metrics
    monkeypatch.setattr(global_metrics, "dump",
                        lambda: {"counters": {"other": 1.0}})
    assert harness.reader("syncs_per_wave.stream").read({}) is None
