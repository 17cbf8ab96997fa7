"""The readings that a cell's correctness limits are set from.

    python3 bench_port/calibrate.py --workload <cell> \
        --out chiprun_out/cal_<cell>.json
    python3 bench_port/calibrate.py --workload <cell> --summary <json>

Every seed of a cell runs the same albums (the mix's ``content_seed``
draws them; ``--seed`` only orders them and draws the album and tracks
checked), so this reads every track that a run can check, at the cell's
own sizes on the card: each album rendered and mastered by the entry
its traffic mix names, as a run does, and every one of its tracks judged
against the plain reference its configuration names (the reference's
output rounded as the mix's wire rounds, as a run judges it).  The
control, the reference computed in TF32 (``precision="tf32"``), is
judged in the program's place on every :data:`CONTROL_EVERY`-th track,
and each fault of ``faults.faults_for`` (planted under the entry) on
every track.  The
benchmark's own runs never run this.  The lower reading is the largest
the program gives over all tracks, the upper the smallest the control
gives.

The summary (printed, and kept in the output) holds, for the limits of
``cells/<cell>.json``, the share of seeds on which a run's check would
fail the program, the control and each fault: the album drawn as the
run's reservoir draws it over a window that cycles the schedule, the
tracks as :func:`correctness.pick_tracks` draws them.  ``--summary``
works it out again from an earlier output, on any machine.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import correctness, faults, registry, traffic  # noqa: E402
from bench_port.run import Program, card_line, log  # noqa: E402

SEED = 2 ** 31 + 2026   # orders the albums; every seed renders the same
CONTROL_EVERY = 4
WORKERS = 6             # reference processes: the card's host has 8 cores


def read_tracks(cell, device="cuda", workers=WORKERS):
    """Per-track readings of every album of the cell's schedule."""
    prog = Program(cell, SEED, device)
    prog.warm()
    names = faults.faults_for(cell.traffic)
    chain = prog.chain_for_reference()
    how = dict(reference=prog.reference, wire=prog.wire)
    ctx = multiprocessing.get_context("spawn")
    out, pending, j = [], [], 0
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        for k, plan in enumerate(prog.plans):
            ys = {"program": prog.call(k)}
            for name in names:
                ys[name] = faults.FAULTS[name](prog.fn)(
                    prog.batches[k], prog.params[k], plan.lengths)
            prog.sync()
            batch = []
            for i, n in enumerate(plan.lengths):
                x = prog.entry.track_in(prog.batches[k], i, n)
                y = {a: prog.entry.track_out(v, i, n)
                     for a, v in ys.items()}
                control = j % CONTROL_EVERY == 0
                j += 1
                fut = pool.submit(correctness.track_readings, x,
                                  y.pop("program"), plan.settings, chain,
                                  control, y, **how)
                batch.append(({"content": _content(plan, i), "track": i,
                               "frames": n,
                               "material": plan.tracks[i].material}, fut))
            del ys
            for rec, fut in pending:     # two albums in flight at most
                rec.update(fut.result())
                out.append(rec)
            pending = batch
        for rec, fut in pending:
            rec.update(fut.result())
            out.append(rec)
    return out


def _content(plan, i):
    """A track's identity, whatever order a seed dispatches albums in."""
    return plan.tracks[i].seed


def summary(cell, tracks, seeds=2000, window_albums=200):
    """For the cell's limits: the lower and upper readings, and the share
    of ``seeds`` on which a run's check fails each output (the album
    drawn by a reservoir over ``window_albums`` albums of the schedule the
    seed orders, the tracks by ``pick_tracks``), and each fault's least
    reading over the tracks (on a track a fault leaves alone, the
    program's)."""
    limits = cell.limits
    by_id = {r["content"]: r for r in tracks}
    outputs = sorted({a for r in tracks for a in r
                      if isinstance(r[a], dict)})
    fails = {a: 0 for a in outputs}
    seen = {a: 0 for a in outputs}
    for s in range(seeds):
        seed = SEED + 7919 * s
        plans = traffic.schedule(cell.traffic, 44100, seed)
        res = correctness.Reservoir(seed + 1)
        for n in range(window_albums):
            res.offer(n % len(plans))
        plan = plans[res.item]
        idx = correctness.pick_tracks(plan.lengths,
                                      int(cell.traffic["check_tracks"]),
                                      seed + 2)
        recs = [by_id[_content(plan, i)] for i in idx]
        for a in outputs:
            got = [r[a] for r in recs if a in r]
            if not got:
                continue
            seen[a] += 1
            fails[a] += any(g[m] > lim or not math.isfinite(g[m])
                            for g in got for m, lim in limits.items())
    lower = {m: max(r["program"][m] for r in tracks)
             for m in correctness.NUMBERS}
    ctl = [r["control"] for r in tracks if "control" in r]
    upper = ({m: min(c[m] for c in ctl) for m in correctness.NUMBERS}
             if ctl else {})
    worst = {a: {m: min(r[a][m] for r in tracks if a in r)
                 for m in correctness.NUMBERS}
             for a in outputs if a not in ("program", "control")}
    return {"limits": limits, "lower": lower, "upper": upper,
            "fault_least": worst, "tracks": len(tracks),
            "control_tracks": len(ctl),
            "fail_share": {a: fails[a] / seen[a] if seen[a] else None
                           for a in outputs}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--out")
    ap.add_argument("--summary", help="an earlier output to summarise")
    args = ap.parse_args(argv)
    cell = registry.cell(args.workload)
    if args.summary:
        out = json.loads(Path(args.summary).read_text())
        print(json.dumps(summary(cell, out["tracks"]), indent=1))
        return 0
    if not args.out:
        ap.error("--out is needed to read the card")
    t0 = time.perf_counter()
    tracks = read_tracks(cell)
    out = {"workload": args.workload, "card": card_line(),
           "tracks": tracks}
    out["summary"] = summary(cell, tracks)
    out["seconds"] = time.perf_counter() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    log(json.dumps({k: out[k] for k in ("summary", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
