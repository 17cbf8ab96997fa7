"""The boundary walk K5 on the card: its compiler report, the dependent
chain of its run walker's step counted in the SASS, and its time on the
180 s track's targets against the latency bound.

    python3 scripts/k5_probe.py [--out DIR]

Builds the port's kernels from this checkout; prints ptxas's report for
``csrc/ballistics.cu``; writes the SASS of K5's two kernels
(``cuobjdump -sass``) to ``DIR/k5_sass.txt`` (default: beside the built
library, which git ignores); and for each straight-line stretch of SASS
that walks steps (the run walker's unrolled block, the hull pass's loop
body) prints its instructions and static stall cycles a step.  In the
walker's block it finds each step's output (the register that the next
step's two adds and its compare read) and counts the static cycles from
one step's output to the next: the dependent chain a step, and the path
it takes (each instruction's latest-issued producer, with the gap before
it).  Then, on the worker and
the legacy chain's targets (``chip_smoke.chain_targets``), it reads the SM
clock with ``nvidia-smi`` while K5 runs and prints K5's time (CUDA
events, ``chip_smoke.queued_ms``), its two launches alone, and its
latency bound: the longest run's live steps times the chain's cycles at
that clock.  Last, K5's run walk on R rows of one same 52-block live run
(R = 1, 8, 64, 300: as many runs, walked at once), ns a step: whether
walkers slow each other.  Needs an NVIDIA GPU and ``cuobjdump`` beside
``nvcc``.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (the card's setup, targets, timing)
from k8_probe import instructions, opcodes  # noqa: E402

CONTROL = ("BRA", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "BAR", "RET", "CALL",
           "BPT", "JMP", "NANOSLEEP")


def sass_by_function(so):
    """``{function name: SASS text}`` of K5's kernels in ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {name: body for name, body in zip(parts[1::2], parts[2::2])
            if "pass1_" in name}


def parse(text):
    """``(opcode, destination registers, source registers)`` of one SASS
    instruction (predicates count as registers)."""
    guard = re.match(r"@!?(U?P\d)\s+(.*)", text)
    srcs = []
    if guard:
        srcs.append(guard.group(1))
        text = guard.group(2)
    op, _, rest = text.partition(" ")
    args = [a.strip() for a in rest.split(",")] if rest else []

    def regs(a):
        return re.findall(r"\b(U?R\d+|U?P\d)\b", a)

    dest = regs(args[0]) if args and not op.startswith(("ST", "RED")) else []
    for a in args[0 if not dest else 1:]:
        srcs += regs(a)
    return op.split(".")[0], dest, srcs


def stretches(ins):
    """The straight-line stretches of ``ins`` (split at control flow)."""
    out, cur = [], []
    for v in ins:
        cur.append(v)
        if parse(v[1])[0] in CONTROL:
            out.append(cur)
            cur = []
    return out + [cur] if cur else out


def steps_of(stretch):
    """A stretch's steps (two products each, ``m*ca`` and ``m*cr``), its
    instructions and static stall cycles a step."""
    ops = [parse(t)[0] for _, t, _ in stretch]
    steps = sum(o == "FMUL" for o in ops) / 2
    return steps, len(stretch) / max(steps, 1), sum(
        st for *_, st in stretch) / max(steps, 1)


def chain(stretch):
    """The walker's dependent chain in a stretch: the static cycles from
    one step's output to the next (each instruction issues at the sum of
    the stall counts before it), and the path between them in a middle
    step: from the next output back to this one, each instruction's
    latest-issued producer (a predicated instruction also waits for the
    last write of its destination), with the gap before each."""
    parsed = [parse(t) for _, t, _ in stretch]
    guarded = [t.startswith("@") for _, t, _ in stretch]
    cycle, c = [], 0
    for *_, st in stretch:
        cycle.append(c)
        c += st
    last, producers, consumers = {}, [], {}
    for i, (op, dest, srcs) in enumerate(parsed):
        deps = srcs + (dest if guarded[i] else [])
        producers.append([last[r] for r in deps if r in last])
        for j in producers[-1]:
            consumers.setdefault(j, []).append(i)
        for r in dest:
            last[r] = i
    # a step's output: read by the next step's two adds and its compare
    outs = [i for i in range(len(parsed))
            if sum(parsed[j][0] == "FADD" for j in consumers.get(i, ())) >= 2
            and any(parsed[j][0] == "FSETP" for j in consumers.get(i, ()))]
    per_step = [cycle[b] - cycle[a] for a, b in zip(outs, outs[1:])]
    path = []
    if len(outs) > 2:
        a, i = outs[len(outs) // 2 - 1], outs[len(outs) // 2]
        while i != a:
            before = [j for j in producers[i] if j >= a]
            if not before:
                break
            j = max(before, key=lambda k: cycle[k])
            path.append(f"{parsed[j][0]} +{cycle[i] - cycle[j]} "
                        f"{parsed[i][0]}")
            i = j
    return {"step_outputs": len(outs),
            "cycles_a_step_min": min(per_step) if per_step else None,
            "cycles_a_step_median": (statistics.median(per_step)
                                     if per_step else None),
            "cycles_a_step_max": max(per_step) if per_step else None,
            "chain_path": path[::-1]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = cs.setup_card()
    import torch

    from python_audio_mastering_tpu_torch.ops import _kernels
    from python_audio_mastering_tpu_torch.ops import ballistics as bal

    kl = _kernels.library()
    section = kl.compiler_log.split("== ballistics.cu\n", 1)[1].split(
        "\n== ", 1)[0]
    print("ptxas, ballistics.cu:")
    for line in section.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill",
                                   "smem")):
            print("  " + line.strip())
    out = args.out or str(kl.path.parent)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "k5_sass.txt")
    funcs = sass_by_function(kl.path)
    found = {}
    with open(path, "w") as f:
        for name, body in funcs.items():
            f.write(f"Function : {name}\n{body}\n")
            ins = instructions(body)
            print(f"{name}: {len(ins)} instructions, "
                  f"{json.dumps(opcodes(body))}")
            for part in stretches(ins):
                steps, n_a_step, stall_a_step = steps_of(part)
                if steps < 8:
                    continue
                rec = {"at": hex(part[0][0]), "steps": steps,
                       "instructions_a_step": round(n_a_step, 3),
                       "stall_cycles_a_step": round(stall_a_step, 3)}
                if "runs" in name:
                    rec.update(chain(part))
                    found = rec
                print(f"  stretch {json.dumps(rec)}")
    print(f"SASS of {len(funcs)} K5 kernels in {path}")
    cycles = found.get("cycles_a_step_min")
    print(f"the run walker's chain: {cycles} cycles a step (the least "
          f"distance between two step outputs; chip_smoke.K5_CHAIN_CYCLES "
          f"{cs.K5_CHAIN_CYCLES})")

    o = cs.main_path_operands(torch.device("cuda"))
    result = {"card": card, "chain_cycles": cycles}
    for name, (m, ca, cr, att0) in cs.chain_targets(o).items():
        hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
        hull = bal.pass1_hull(m, ca, cr, hmax)
        steps = bal.BLOCK * max(st["chain"] for st in bal.walk_stats(*hull))
        clock, clock_max = cs.sm_clock_under(
            lambda: bal.pass1_bnd(m, ca, cr, att0))
        k5 = cs.queued_ms(lambda: bal.pass1_runs(
            m, ca, cr, att0, *bal.pass1_hull(m, ca, cr, hmax)))
        hull_ms = cs.queued_ms(lambda: bal.pass1_hull(m, ca, cr, hmax))
        runs_ms = cs.queued_ms(lambda: bal.pass1_runs(m, ca, cr, att0, *hull))
        bound = steps * (cycles or cs.K5_CHAIN_CYCLES) / (clock * 1e3)
        print(f"K5 on the {name} targets: {k5:.4f} ms (hull {hull_ms:.4f}, "
              f"runs {runs_ms:.4f}); the longest chain {steps} steps, "
              f"{runs_ms * 1e6 / steps:.2f} ns a step in the run walk; SM "
              f"clock {clock:.0f} MHz (max {clock_max:.0f}); latency bound "
              f"{bound:.4f} ms, {100 * bound / k5:.0f} % of K5 ({card})")
        result[name] = {"k5_ms": k5, "hull_ms": hull_ms, "runs_ms": runs_ms,
                        "chain_steps": steps, "sm_clock_mhz": clock,
                        "latency_bound_ms": bound}
    # R runs at once: one 52-block run of sustained targets under slow
    # rates (nothing collapses or freezes) on each of R rows
    run = 6.0 + cs.np.random.default_rng(0).random(52 * bal.BLOCK)
    result["runs_at_once_ns_a_step"] = {}
    for rows in (1, 8, 64, 300):
        m = torch.tensor(cs.np.tile(run, (rows, 1)), dtype=torch.float32,
                         device="cuda")
        ca = torch.full((rows,), 1e-4, device="cuda")
        att0 = torch.zeros(rows, device="cuda")
        hull = bal.pass1_hull(m, ca, ca, m.amax(dim=1).contiguous())
        ns = cs.queued_ms(lambda: bal.pass1_runs(m, ca, ca, att0, *hull)) \
            * 1e6 / run.size
        result["runs_at_once_ns_a_step"][rows] = ns
        print(f"K5's run walk, {rows} runs of 52 live blocks at once: "
              f"{ns:.2f} ns a step ({card})")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
