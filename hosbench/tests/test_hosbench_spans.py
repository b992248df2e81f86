"""The span-read per-layer metrics in a traced CPU rehearsal of each cell
(`python -m hosbench.run --cpu-rehearsal --trace 1`, as
test_hosbench_run.py runs it): every one the cell lists is reported,
except those that need the card (`queue_ms`, `card_waits_per_step`) and
`lbs_useful_share`, which the rehearsal's dense path does not feed.

    python -m pytest -q hosbench/tests/test_hosbench_spans.py
"""

import json
import subprocess
import sys

from hosbench import harness

CARD_ONLY = ("queue_ms", "card_waits_per_step", "lbs_useful_share")


def test_span_metrics_in_a_traced_rehearsal():
    for workload in ("composed.p8", "scene.r4096"):
        proc = subprocess.run(
            [sys.executable, "-m", "hosbench.run", "--workload", workload,
             "--seed", "3000002131", "--seconds", "1", "--trace", "1",
             "--cpu-rehearsal"], cwd=harness.ROOT, capture_output=True,
            text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        new = {m["name"] for m in harness.Cell(workload).per_layer()
               if m["source"] == "host_clock"}
        assert len(new) == (7 if workload == "composed.p8" else 6)
        want = {n for n in new if n.split(".")[0] not in CARD_ONLY}
        got = line["metrics"]
        assert want <= set(got), want - set(got)
        for n in want:
            assert got[n]["value"] >= 0 and got[n]["unit"] == "ms", n
        suffix = "" if workload == "composed.p8" else ".scene"

        def ms(name):
            return got[name + suffix]["value"]
        assert (ms("host_forward_ms") + ms("host_backward_ms")
                <= ms("host_step_ms"))
