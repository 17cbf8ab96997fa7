"""The port's ``utils`` (logging, tracing) against the JAX package's, and
the chain's stage spans under a CPU ``torch.profiler``."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from python_audio_mastering_tpu.utils import logging as jlog
from python_audio_mastering_tpu.utils import tracing as jtrace
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import cached_chain
from python_audio_mastering_tpu_torch.parallel.batch import make_album_fn
from python_audio_mastering_tpu_torch.utils import logging as plog
from python_audio_mastering_tpu_torch.utils import tracing as ptrace

from .conftest import make_signal


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
    jtrace.clear_trace()
    with ptrace.recording():
        for mod in (ptrace, jtrace):
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
    with ptrace.recording():
        pass
    assert ptrace.get_trace() == []


def test_span_sync_waits_on_what_it_is_given():
    calls = []
    with ptrace.span("unrecorded", sync=lambda: calls.append(0)):
        pass
    with ptrace.recording():
        with ptrace.span("callable", sync=lambda: calls.append(1)):
            pass
        with ptrace.span("tensor", sync=torch.ones(3)):  # a CPU tensor: no wait
            pass
        with ptrace.span("device", sync="cpu"):
            pass
    assert calls == [1]
    assert [r["name"] for r in ptrace.get_trace()] == ["callable", "tensor",
                                                       "device"]


def test_unobserved_span_keeps_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(ptrace._profiler, "record_function",
                        lambda name: opened.append(name))
    with ptrace.recording():
        pass
    for _ in range(1000):
        with ptrace.span("chain", tag=1) as rec:
            with ptrace.span("states"):
                assert rec is None
    assert opened == [] and ptrace.get_trace() == []
    assert ptrace._state.stack == []


def test_span_lands_in_the_profiler_record():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ptrace.span("outer"):
            with ptrace.span("inner"):
                torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(ptrace.PREFIX)]
    assert sorted(names) == ["pam.outer", "pam.outer/inner"]
    assert ptrace.get_trace() == [] and ptrace._state.stack == []


FS = 44100
# the spans each chain opens on an album, and under whom (the path's head)
SPANS = {
    "worker_mb": {"chain", "chain/front", "chain/front/states",
                  "chain/multiband", "chain/multiband/states",
                  "chain/multiband/detector", "chain/loudness",
                  "chain/loudness/states", "chain/limiter"},
    "worker_nomb": {"chain", "chain/front", "chain/front/states",
                    "chain/loudness", "chain/loudness/states",
                    "chain/limiter"},
    "legacy_mb": {"chain", "chain/front", "chain/front/states",
                  "chain/multiband", "chain/multiband/states",
                  "chain/multiband/detector", "chain/loudness",
                  "chain/loudness/states", "chain/limiter"},
    "worker_quality": {"chain", "chain/front", "chain/front/states",
                       "chain/loudness", "chain/loudness/states",
                       "chain/limiter", "chain/limiter/truepeak",
                       "chain/limiter/attack", "chain/limiter/release"},
}


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _profiled_album(case):
    """The profiler's events of one small album through the album entry,
    and of the same album through ``forward_tracks`` alone."""
    cfg = ChainConfig.gpu_default(FS)
    if case.startswith("legacy"):
        cfg = dataclasses.replace(cfg, variant="legacy")
    if case.endswith("quality"):
        cfg = dataclasses.replace(cfg, limiter_mode="lookahead_truepeak")
    params = MasteringParams.from_settings(
        {"saturation": 20, "preset": "techno", "width": 1.3, "lufs": -14.0,
         "multiband": case.endswith("_mb")})
    lengths = [FS, FS // 2]
    batch = torch.as_tensor(np.stack([
        make_signal(FS, channels=2, fs=FS, seed=40 + i) * 0.5
        for i in range(2)]).astype(np.float32))
    batch[1, lengths[1]:] = 0.0
    fn = make_album_fn(cfg, device="cpu")
    fn(batch, params, lengths)   # operators built outside the record
    with profile(activities=[ProfilerActivity.CPU]) as album:
        fn(batch, params, lengths)
    chain = cached_chain(cfg, torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as tracks:
        chain.forward_tracks(batch, [params] * 2, lengths)
    return _events(album), _events(tracks)


@pytest.mark.parametrize("case", sorted(SPANS))
def test_chain_opens_its_stage_spans(case):
    events, tracks = _profiled_album(case)
    spans = [(n[len(ptrace.PREFIX):], a, b) for n, a, b in events
             if n.startswith(ptrace.PREFIX)]
    assert {n for n, _, _ in spans} == SPANS[case]
    assert sum(n == "chain" for n, _, _ in spans) == 1
    for name, a, b in spans:      # each inside a span of its parent path
        if "/" in name:
            parent = name.rsplit("/", 1)[0]
            assert any(p == parent and pa <= a and b <= pb
                       for p, pa, pb in spans), name
    (c0, c1), = [(a, b) for n, a, b in tracks if n == "pam.chain"]
    aten = [(n, a, b) for n, a, b in tracks if n.startswith("aten::")]
    assert aten
    assert all(c0 <= a and b <= c1 for _, a, b in aten), [
        n for n, a, b in aten if not (c0 <= a and b <= c1)][:5]
