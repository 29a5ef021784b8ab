"""The last line's shape, plain and traced."""

import json

import pytest

from benchmark.harness import main as M
from benchmark.tests._runs import cpu_run


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(capsys, trace):
    res = cpu_run("streamed.orbit", trace=trace)
    M.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms",
                                        "setup_s"}
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]
    assert line["check"]["off_share"]["limit"] is not None
    # the check's numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-2:]
    assert tail[0].startswith("check off_share:") and "limit" in tail[0]
    assert tail[1].startswith("check correct: True")
