"""The port's ``utils`` (logging, tracing) against the JAX package's."""

import json
import logging
import os

import pytest
import torch

from python_audio_mastering_tpu.utils import logging as jlog
from python_audio_mastering_tpu.utils import tracing as jtrace
from python_audio_mastering_tpu_torch.utils import logging as plog
from python_audio_mastering_tpu_torch.utils import tracing as ptrace


def _record(msg="hello %s", args=("there",), extra=None):
    rec = logging.LogRecord("pam.test", logging.WARNING, __file__, 1, msg,
                            args, None)
    if extra is not None:
        rec.extra_fields = extra
    return rec


@pytest.mark.parametrize("extra", [None, {"job": "abc", "n": 3}])
def test_json_formatter_matches_jax(extra):
    got = json.loads(plog._JsonFormatter().format(_record(extra=extra)))
    ref = json.loads(jlog._JsonFormatter().format(_record(extra=extra)))
    assert abs(got.pop("ts") - ref.pop("ts")) < 5.0
    assert got == ref


def test_log_loudness_line_matches_jax(caplog):
    for mod, name in ((plog, "pam.port"), (jlog, "pam.jax")):
        logger = logging.getLogger(name)
        logger.propagate = True
        with caplog.at_level(logging.INFO, logger=name):
            mod.log_loudness(logger, -17.04285, 3.04285)
    port, jax_ = (r.getMessage() for r in caplog.records[-2:])
    assert port == jax_ == ("Current loudness: -17.04 LUFS. Applying 3.04 "
                            "dB gain...")


def test_get_logger_json_mode(monkeypatch, capsys):
    monkeypatch.setenv("PAM_LOG_FORMAT", "json")
    logger = plog.get_logger("pam.utils_test_json")
    assert plog.get_logger("pam.utils_test_json") is logger
    assert len(logger.handlers) == 1 and not logger.propagate
    logger.info("ok")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["message"] == "ok"


def test_spans_nest_and_summarize_as_jax():
    for mod in (ptrace, jtrace):
        mod.clear_trace()
        with mod.span("outer", tag=1):
            with mod.span("inner"):
                pass
            with mod.span("inner"):
                pass
    got, ref = ptrace.get_trace(), jtrace.get_trace()
    assert [r["name"] for r in got] == [r["name"] for r in ref] == [
        "outer/inner", "outer/inner", "outer"]
    assert got[-1]["tag"] == 1 and all(r["dur_ms"] >= 0 for r in got)
    names = [line.split()[0] for line in ptrace.trace_summary().splitlines()]
    assert sorted(names) == ["outer", "outer/inner"]
    assert "n=   2" in ptrace.trace_summary()
    ptrace.clear_trace()
    assert ptrace.get_trace() == []


def test_span_sync_waits_on_what_it_is_given():
    calls = []
    ptrace.clear_trace()
    with ptrace.span("callable", sync=lambda: calls.append(1)):
        pass
    with ptrace.span("tensor", sync=torch.ones(3)):     # a CPU tensor: no wait
        pass
    with ptrace.span("device", sync="cpu"):
        pass
    assert calls == [1]
    assert [r["name"] for r in ptrace.get_trace()] == ["callable", "tensor",
                                                       "device"]


def test_counters_match_jax():
    for mod in (ptrace, jtrace):
        c = mod.counters("utils_test.jobs")
        c.inc()
        c.inc(4)
    assert (ptrace.counters.snapshot()["utils_test.jobs"]
            == jtrace.counters.snapshot()["utils_test.jobs"] == 5)
    assert json.loads(ptrace.counters.dump_json())["utils_test.jobs"] == 5


def test_profiler_trace_writes_a_trace(tmp_path):
    with ptrace.profiler_trace(str(tmp_path)):
        torch.ones(64).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)
