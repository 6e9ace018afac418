"""The port's SSD300 headline bench run N times back-to-back (the counterpart of
``scripts/bench_headline.py``).

Runs ``python bench_torch.py`` N times (default 3), one process each, on the
same card with the host otherwise idle; prints every sample, then writes
BENCH_HEADLINE_TORCH.json at the root of the checkout with the samples, their
median and ``spread_pct`` (max - min over the median), and prints it as one
JSON line last. The port has no baseline of its own, so there is no
``vs_baseline`` field.

Usage: python scripts/bench_headline_torch.py [N]
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "BENCH_HEADLINE_TORCH.json")


def _last_json(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.strip().splitlines() if ln.startswith("{")][-1])


def main(n=3, command=None, out=OUT) -> dict:
    command = command or [sys.executable, os.path.join(ROOT, "bench_torch.py")]
    samples = []
    for i in range(n):
        run = subprocess.run(command, capture_output=True, text=True, check=False, cwd=ROOT)
        if run.returncode:
            sys.stderr.write(run.stderr[-4000:])
            raise RuntimeError(f"run {i + 1}/{n} of {command} exited {run.returncode}")
        rec = _last_json(run.stdout)
        print(f"run {i + 1}/{n}: {rec['value']} {rec['unit']} "
              f"(scanned {rec.get('scan_epoch_imgs_per_sec')})", flush=True)
        samples.append(rec)
    values = [r["value"] for r in samples]
    median = statistics.median(values)
    result = {
        "metric": samples[0]["metric"],
        "unit": samples[0]["unit"],
        "samples": values,
        "median": median,
        "spread_pct": round(100.0 * (max(values) - min(values)) / median, 2),
        "scan_epoch_samples": [r.get("scan_epoch_imgs_per_sec") for r in samples],
        "device": samples[0].get("device"),
        "protocol": "bench_torch.py x%d back-to-back, one process each" % n,
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
