"""Run ``chip_smoke.py``'s phase 23 (pipeline parallelism at BERT-base
widths) alone on one GPU: build the kernels, then ``run_pipeline``.

    python3 scripts/torch_pipeline_phase.py [--serial]

By default the phase runs as the smoke runs it: the gpipe and 1f1b rank
worlds beside each other and beside the in-process legs (the line's
``contended`` is true).  With ``--serial`` each world, then each leg,
runs alone on the card, so each rank's step ms, bubble share and hop
waits are its own.

Prints the kernels' build seconds, the card's name and power limit, the
phase lines and the ``pipeline`` JSON line (per schedule: the f32 step
against the sequential oracle, the bf16 losses, each rank's step ms,
bubble share, hop waits, startup marks and launches; the REST leg), then
the failed phases and the seconds taken; exits 1 when a phase failed.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    print("build", build.build(), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="p23_")
    res = chip_smoke.run_pipeline(tmp, card,
                                  overlap="--serial" not in sys.argv[1:])
    print("pipeline " + json.dumps(res["line"], default=str), flush=True)
    print("FAILURES", chip_smoke.failures, flush=True)
    print("total_s", time.perf_counter() - t0, flush=True)
    return 1 if chip_smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main())
