"""The port's logging configuration, runtime tracker and profiler trace (on the CPU)."""

import json
import logging

import torch

from artist_tpu_torch.util import logging_utils


def test_set_logger_config_writes_the_format_to_a_file(tmp_path):
    path = tmp_path / "log.txt"
    logging_utils.set_logger_config(level=logging.DEBUG, log_file=path, log_to_stderr=False, process_index=3)
    logger = logging.getLogger("artist_tpu_torch.optim")
    logger.debug("hello %d", 7)
    base = logging.getLogger("artist_tpu_torch")
    assert base.level == logging.DEBUG and not base.propagate and len(base.handlers) == 1
    for handler in base.handlers:
        handler.flush()
    line = path.read_text().strip()
    assert line.endswith("[p3][artist_tpu_torch.optim][DEBUG] hello 7")
    # Configuring again replaces the handlers instead of adding to them.
    logging_utils.set_logger_config(log_to_stderr=True)
    assert len(base.handlers) == 1 and base.level == logging.INFO


def test_track_runtime_logs_start_finish_and_duration(tmp_path):
    path = tmp_path / "runtime_log.txt"
    logging_utils.set_runtime_logger(path)

    @logging_utils.track_runtime
    def work(x, y=2):
        return x * y

    assert work(21) == 42 and work.__name__ == "work"
    for handler in logging_utils.runtime_log.handlers:
        handler.flush()
    lines = path.read_text().splitlines()
    name = f"{__name__}.test_track_runtime_logs_start_finish_and_duration.<locals>.work"
    assert lines[0].endswith(f"started: {name}")
    assert f"finished: {name} duration_s=" in lines[1]
    assert float(lines[1].rsplit("=", 1)[1]) >= 0.0
    for handler in list(logging_utils.runtime_log.handlers):
        logging_utils.runtime_log.removeHandler(handler)
        handler.close()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    @logging_utils.track_runtime
    def matmul():
        return torch.ones(8, 8) @ torch.ones(8, 8)

    with logging_utils.profile_trace(tmp_path / "profile"):
        matmul()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    names = {event.get("name") for event in trace["traceEvents"]}
    assert any(name and name.endswith("matmul") for name in names)
