"""The readings that the limits of ``correct`` are set from, for one
cell on several seeds in one process.

    python3 simbench/control.py --workload <name> --seeds 1,2,...,12 \
        --seconds 3 [--faulted 3] [--out readings.jsonl]

For each seed: a run's set-up and a short window (``run.session``),
then every compared number of the program against the float64
reference (the lower reading).  On the first ``--faulted`` seeds also,
each against the same float64 reference: the control, the reference
computed and stored in bfloat16 put in the program's place (the upper
reading); a state left unchanged by each chunk; and the reference with
its position update at half speed put in the program's place.  Each of
these has to come out not correct under the cell's limits (``judge``);
the command exits 1 where one does not.  One JSON line a seed.  The
benchmark's own runs never run these.
"""
import argparse
import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from simbench import check, drive, run  # noqa: E402
from simbench.reference import step as refstep  # noqa: E402

CONTROL = torch.bfloat16


@contextlib.contextmanager
def half_speed():
    """The reference's step moving every aircraft half as far."""
    orig = refstep.step

    def step(s, env, simdt, fms, asas_update=None):
        rows = {}               # the interval's rows: the sample's

        def update(cur):
            out = asas_update(cur)
            rows.update(out)
            return dict(out)
        new, unsure = orig(s, env, simdt, fms,
                           update if asas_update else None)
        old = rows or s
        for k in ("lat", "lon"):
            new[k] = old[k] + 0.5 * (new[k] - old[k])
        return new, unsure
    refstep.step = step
    try:
        yield
    finally:
        refstep.step = orig


def as_program(ref):
    """A reference's side in the program's place."""
    return dict(start=ref["start"], first=check.as_post(ref["first"]),
                last=check.as_post(ref["last"]))


def unchanged(s):
    """The program's side had every chunk left its state as it was."""
    pick = lambda d: {k: (v[s["sample"]] if k in drive.FIELDS else v)
                      for k, v in d.items()}
    prog = s["prog"]
    return dict(start=prog["start"],
                first=dict(prog["start"], nconf_cur=prog["first"]["nconf_cur"],
                           nlos_cur=prog["first"]["nlos_cur"]),
                last=dict(pick(s["pre"]), nconf_cur=prog["last"]["nconf_cur"],
                          nlos_cur=prog["last"]["nlos_cur"]))


def faulted(s, ref, device):
    """The compared numbers of the control and of each planted fault."""
    out = dict(control=check.compare(as_program(run.references(
        s, device, CONTROL, CONTROL)), ref))
    with half_speed():
        out["half_speed"] = check.compare(
            as_program(run.references(s, device)), ref)
    out["unchanged"] = check.compare(unchanged(s), ref)
    return out


def readings(args, device="cuda", root=run.ROOT, require_card=True):
    """Yield one dict a seed: ``seed``, ``correct``, the ``program``'s
    numbers, ``excused``, and on the first ``args.faulted`` seeds the
    numbers of the control and the faults, each with its ``judge``."""
    for i, seed in enumerate(args.seeds):
        a = argparse.Namespace(workload=args.workload, seed=seed,
                               seconds=args.seconds, trace=0)
        s = run.session(a, device, require_card, root)
        if s is None:
            return
        correct, rows, ref = run.verdict(s, device)
        r = dict(seed=seed, correct=correct,
                 program={k: v for k, v, _ in rows},
                 excused={k: check.excused(ref[k]) for k in ("first",
                                                             "last")})
        if i < args.faulted:
            for name, nums in faulted(s, ref, device).items():
                r[name] = nums
                r[f"{name}_correct"] = check.judge(nums,
                                                   s["cell"].limits)[0]
        yield r
        del s, ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   type=lambda v: [int(x) for x in v.split(",")])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faulted", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    run.caches()
    fh = open(args.out, "a") if args.out else None
    passed = []
    try:
        for r in readings(args):
            passed += [(r["seed"], k) for k in r
                       if k.endswith("_correct") and r[k]]
            line = json.dumps(r, default=float)
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()
    finally:
        if fh:
            fh.close()
    if passed:
        print(f"came out correct: {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
