"""The readings a cell's correctness limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        --calls 2 --control tf32 --control-seeds 3

For every seed: the cell's set-up, ``--calls`` calls of its timed path
at its own size, then the numbers the check compares, the program's
answers against the reference; for the first ``--control-seeds`` seeds
also the control's, the reference in each ``--control`` precision put
in the program's place. One JSON line per seed; with ``--out`` the lines
are also written to that file. A run of the benchmark never runs this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def calibrate(cell_name, seeds, calls, controls, control_seeds, device,
              overrides=None, emit=print):
    """Yield one dict of readings per seed (see the module docstring)."""
    import torch

    from portbench import harness, spec

    overrides = overrides or {}
    bench = spec.benchmark()
    w = spec.workload(bench, cell_name)
    config = overrides.get("config") or spec.config(bench, w["config"])[1]
    traffic = overrides.get("traffic") or spec.traffic(w["traffic"])
    drv = spec.driver(traffic["driver"])
    out = []
    for j, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell = drv.Cell(config, traffic, seed, torch.device(device),
                        harness.Spans(False))
        cell.setup()
        t1 = time.perf_counter()
        for i in range(calls):
            cell.step(i)
        harness.sync()
        t2 = time.perf_counter()
        cell.release()
        refs = cell.references()
        t3 = time.perf_counter()
        row = {"seed": seed, "program": cell.readings(refs),
               "seconds": {"setup": t1 - t0, "calls": t2 - t1,
                           "reference": t3 - t2}}
        if j < control_seeds:
            for prec in controls:
                row[prec] = cell.control_readings(refs, prec)
        row["seconds"]["control"] = time.perf_counter() - t3
        emit(json.dumps(row))
        out.append(row)
        del cell, refs
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--control", nargs="*", default=["tf32"])
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    a = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    harness.clean_env()
    rows = calibrate(a.workload, a.seeds, a.calls, a.control,
                     a.control_seeds, a.device,
                     emit=lambda s: print(s, flush=True))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"calibrate: {len(rows)} seed(s) in "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
