"""Summarize a training run: PSNR curve and population from its artifacts.

The port's copy of tools/summarize_run.py. Reads <model_dir>/log_file.txt
(the Trainer's JSON line per report, reference train.py:213-214) and,
when given, the run's log for its population and rate lines ("[ITER]
loss L gaussians N it/s R", the Trainer's, with or without the seconds
stamp the port's scripts put before them); prints a markdown table.

Run:  python -m rain_tpu_torch.scripts.summarize_run MODEL_DIR [RUN_LOG]
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

POPULATION = re.compile(r"\[(\d+)\] loss ([\d.]+) gaussians (\d+) "
                        r"it/s ([\d.]+)")


def summarize(model_dir, run_log=None) -> str:
    """The tool's markdown for ``model_dir`` (and ``run_log``)."""
    rows = [json.loads(line) for line in
            (Path(model_dir) / "log_file.txt").read_text().splitlines()
            if line.strip()]
    nan = float("nan")
    out = ["| iteration | test PSNR | test SSIM | test L1 | train PSNR |",
           "|---|---|---|---|---|"]
    for r in rows:
        t = r.get("test", {})
        tr = r.get("train", {})
        out.append(f"| {r['iteration']} | {t.get('psnr', nan):.2f} | "
                   f"{t.get('ssim', nan):.4f} | {t.get('l1', nan):.4f} | "
                   f"{tr.get('psnr', nan):.2f} |")
    if run_log is not None:
        pops = POPULATION.findall(Path(run_log).read_text())
        if pops:
            out.append("\npopulation: " + " → ".join(
                f"{int(i) // 1000}k:{int(g)}" for i, _, g, _ in
                pops[:: max(1, len(pops) // 12)]))
            out.append(f"final cumulative rate: {pops[-1][3]} it/s at iter "
                       f"{pops[-1][0]}")
    return "\n".join(out)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir")
    p.add_argument("run_log", nargs="?", default=None)
    args = p.parse_args(argv)
    text = summarize(args.model_dir, args.run_log)
    print(text)
    return text


if __name__ == "__main__":
    main()
