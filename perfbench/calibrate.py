#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the program's numbers
on many seeds (the lower readings) and the control's (the upper ones),
in one process, each seed a short window of the cell's own traffic at
its own size.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n,...> [--control-seeds <n,...>] [--numbers <a,...>] \
        [--out <file>]

The control is the plain reference put in the program's place and
computed with every product's operands in float8 e4m3
(``reference.common.Prec("fp8")``), the precision below the bfloat16
that the configurations state. It is judged against the float32
reference by the same numbers as the program. One JSON line a seed goes
to standard output (and to ``--out``). The benchmark's runs never run
this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(workload: str, seconds: float, seeds: list, control: list,
             device="cuda", overrides=None, names=None):
    """Yield one dict a seed: the program's numbers, and the control's
    where the seed is among ``control``; ``names`` the numbers (the
    cell's limits where None)."""
    import torch

    from perfbench import harness
    from perfbench.reference.common import Prec
    overrides = overrides or {}
    c = harness.open_cell(workload, overrides)
    names = sorted(c.limits) if names is None else names
    harness.plain_products()
    share = harness.build_share(c.conf, torch.device(device),
                                overrides.get("cfg"))
    for seed in seeds:
        run = harness.new_run(c, share, seed, seconds)
        driver = run.driver
        driver.setup()
        driver.window()
        got = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
               for k, v in driver.program_outputs().items()}
        ref = driver.reference_outputs(Prec("f32"))
        out = {"seed": seed, "ops": run.attempted,
               "program": driver.judge(got, ref, names)}
        if seed in control:
            ctl = driver.reference_outputs(Prec("fp8"))
            out["control"] = driver.judge(ctl, ref, names)
        del driver, got, ref, run
        if share.device.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--numbers", default="",
                    help="numbers to read (default: the cell's limits')")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    control = [int(s) for s in a.control_seeds.split(",") if s]
    seeds += [s for s in control if s not in seeds]
    sink = open(a.out, "a") if a.out else None
    t0 = time.time()
    names = [n for n in a.numbers.split(",") if n] or None
    for r in readings(a.workload, a.seconds, seeds, control, names=names):
        r["workload"], r["t_s"] = a.workload, time.time() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
