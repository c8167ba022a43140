"""The host helpers of the port's ``utils/perf.py`` (``log_system_info``,
``torch_profile``) and the logging setup, on the CPU, and the JAX
package's ``timer`` and ``time_function``, which the port leaves out (its
spans and CUDA events take their place: ``tests/test_torch_tracing.py``)."""

import json
import logging
import os

import pytest
import torch

from icl_speech_text_llm_tpu.utils import perf as jperf
from icl_speech_text_llm_tpu_torch.utils import perf as tperf
from icl_speech_text_llm_tpu_torch.utils.logging_utils import setup_logging

torch.set_num_threads(1)


@pytest.mark.parametrize("perf", [jperf], ids=["jax"])
def test_timer_logs_the_block_s_seconds(perf, caplog):
    with caplog.at_level(logging.INFO, logger=perf.logger.name):
        with perf.timer("block"):
            sum(range(1000))
        with perf.timer("quiet", log=False):
            pass
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1 and lines[0].startswith("block took ") and lines[0].endswith("s")
    assert float(lines[0][len("block took "):-1]) >= 0.0


@pytest.mark.parametrize("perf", [jperf], ids=["jax"])
def test_time_function_wraps_and_logs_by_name(perf, caplog):
    @perf.time_function
    def add(a, b=1):
        """doc"""
        return a + b

    with caplog.at_level(logging.INFO, logger=perf.logger.name):
        assert add(2, b=3) == 5
    assert add.__name__ == "add" and add.__doc__ == "doc"
    assert [r.getMessage().split(" took ")[0] for r in caplog.records] == ["add"]


def test_log_system_info_names_torch_and_the_devices(caplog):
    with caplog.at_level(logging.INFO, logger=tperf.logger.name):
        tperf.log_system_info()
    text = caplog.text
    assert f"torch {torch.__version__}" in text and "devices:" in text
    if not torch.cuda.is_available():
        assert "no CUDA device" in text


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    with tperf.torch_profile(str(out)) as prof:
        with tperf.span("outer"):
            x = torch.randn(64, 64)
            with tperf.span("inner"):
                (x @ x).sum()
    assert prof is not None
    files = os.listdir(out)
    assert len(files) == 1 and files[0].startswith(f"trace_{os.getpid()}_")
    with open(out / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    ranges = {e["name"]: e for e in trace["traceEvents"] if e.get("name", "").startswith("port/")}
    assert set(ranges) == {"port/outer", "port/inner"}
    outer, inner = ranges["port/outer"], ranges["port/inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_torch_profile_without_a_dir_traces_nothing(tmp_path):
    with tperf.torch_profile(None) as prof:
        pass
    with tperf.torch_profile("") as prof2:
        pass
    assert prof is None and prof2 is None


def test_setup_logging_writes_the_file(tmp_path):
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        log_file = tmp_path / "sub" / "run.log"
        logger = setup_logging(str(log_file), level=logging.INFO)
        logger.info("hello from the port")
        for h in logger.handlers:
            h.flush()
        text = log_file.read_text()
        assert "INFO - hello from the port" in text
    finally:
        for h in root.handlers:
            if h not in saved[0]:
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
