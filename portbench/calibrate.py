"""The readings a cell's limits are set from, on the card, with no window.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--fault F]
        [--traffic <mix>] [--probe dD:1.3]

For each seed, in one process: the program's first jobs as a run's set-up
makes them (block 0), then the reference's; with ``--control`` also the
control's, the reference in the program's place one precision below the
configuration's (fp8 products); with ``--fault`` the program runs with that
fault planted (``harness.FAULTS``); with ``--traffic`` the cell's
configuration runs under another mix; with ``--probe <output>:<factor>`` one
output of the SSD chunk scan's backward kernel (``PROBE_OUTPUTS``) is scaled
by the factor, to read how far the numbers see an error in it.  Prints one
JSON line a seed with the numbers compared (``reference/compare.py``).  The
benchmark's runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the SSD chunk scan backward kernel's outputs, in its order
PROBE_OUTPUTS = ("dx", "ddt", "dcum", "dB", "dC", "dh_prev", "dD")


@contextlib.contextmanager
def probe(spec: str | None):
    """Scale one output of the SSD backward kernel the program calls
    (``kernels/ssd_scan/ops.py`` looks it up when it runs), ``spec`` being
    ``<output>:<factor>``."""
    if spec is None:
        yield
        return
    from repro_torch.kernels.ssd_scan import ops

    name, factor = spec.split(":")
    index, factor, program = PROBE_OUTPUTS.index(name), float(factor), ops._scan_bwd_kernel

    def scaled(*args, **kwargs):
        grads = list(program(*args, **kwargs))
        grads[index] = grads[index] * factor
        return tuple(grads)

    ops._scan_bwd_kernel = scaled
    try:
        yield
    finally:
        ops._scan_bwd_kernel = program


def worst_leaves(program: dict, ref: dict, k: int = 3) -> dict:
    """The ``k`` leaves of largest gap in model 0's first gradient and in each
    model's change: (path, program's norm, reference's norm, gap)."""
    from portbench.reference import compare

    def top(own, want):
        rows = zip(want, compare.leaf_gaps(own, want))
        return [(p, own[p], want[p], g) for p, g in sorted(rows, key=lambda r: -r[1])[:k]]

    out = {"grad": top(program["grad_norms"][0], ref["grad_norms"][0])}
    for m, want in ref["change_norms"].items():
        out[f"change{m}"] = top(program["change_norms"][m], want)
    return out


def kinds(program: dict, ref: dict) -> dict:
    """Each kind of leaf in model 0's first gradient: its median gap over the
    layers (``grad_gap_kind``'s terms), and the share of a leaf's own
    relative error that its gap shows, the leaf's norm over the larger of it
    and the median leaf's (median over the layers)."""
    from portbench.reference import compare

    own, want = program["grad_norms"][0], ref["grad_norms"][0]
    gaps = dict(zip(want, compare.leaf_gaps(own, want)))
    median = statistics.median(want.values())
    reach = compare.kind_gaps({p: want[p] / max(want[p], median) for p in want})
    return {k: (g, reach[k]) for k, g in compare.kind_gaps(gaps).items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--traffic", default=None,
                    help="the cell's configuration under this mix (traffic/<mix>.json) instead")
    ap.add_argument("--probe", default=None, help="<SSD backward output>:<factor>")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness, spec
    from portbench.reference import compare

    cell = spec.load_cell(args.workload)
    model, mix = cell.config["model"], cell.mix
    if args.traffic:
        mix = json.loads((spec.HERE / "traffic" / f"{args.traffic}.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        bench = harness.Bench(model, mix, seed, "cuda", fault=args.fault)
        with probe(args.probe):
            bench.setup_block()
        checked = bench.checked
        bench.free()
        del bench
        ref = harness.reference_readings(model, mix, seed, "cuda")
        row = {"workload": args.workload, "traffic": args.traffic, "seed": seed,
               "fault": args.fault, "probe": args.probe,
               "program": compare.numbers(checked, ref),
               "losses": {"program": checked["losses"], "reference": ref["losses"]},
               "worst_leaves": worst_leaves(checked, ref), "kinds": kinds(checked, ref)}
        if args.control:
            ctl = harness.reference_readings(model, mix, seed, "cuda", control=True)
            row["control"] = compare.numbers(ctl, ref)
            row["control_kinds"] = kinds(ctl, ref)
        row["seconds"] = time.perf_counter() - t
        if torch.cuda.is_available():
            row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
