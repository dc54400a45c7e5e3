"""On the card: a short run of the cell comes out correct, with its
end-to-end metrics, and its traced run with the per-layer ones."""

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    res = subprocess.run([sys.executable, "-B", "-m", "portbench.run", "--workload",
                          "cogvideox-5b.train-dpo", "--seed", str(2**31 + 99), "--seconds", "2",
                          "--trace", str(trace)], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert "mfu.train" in out["metrics"]
    else:
        assert {"setup_s", "train_pair_ms", "peak_mem_gib"} <= set(out["metrics"])
