"""The scan kernel K8 on the card: its compiler report, its SASS and its
time by section count.

    python3 scripts/k8_probe.py [--out DIR]

Builds the port's kernels from this checkout; prints ptxas's report
(registers, spills, shared memory) for ``csrc/sos_scan.cu``; writes the
SASS of every K8 kernel in the library (``cuobjdump -sass``) to
``DIR/k8_sass.txt`` (default: beside the built library, which git ignores;
``--out`` names a directory to keep it) and prints
each one's instructions by opcode; reads the SM clock with ``nvidia-smi``
while K8 runs; and prints ``chip_smoke.scan_sweep``: one K8 launch over
one 20 s column at k = 1, 2, 3, 4, 8 sections, in float32 and float64,
in ns a sample.  Needs an NVIDIA GPU and ``cuobjdump`` beside ``nvcc``.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (the card's setup and the sweep)


def sass_by_function(so):
    """``{function name: SASS text}`` of the K8 kernels in ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {name: body for name, body in zip(parts[1::2], parts[2::2])
            if "sos_scan" in name}


def opcodes(body):
    """Instructions of one SASS function by opcode (predicates and
    modifiers dropped)."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     body)
    return dict(collections.Counter(ops).most_common())


def instructions(body):
    """``[(address, text, stall cycles)]`` of one SASS function: the stall
    count is bits 41-44 of the second 64-bit word of each instruction's
    encoding, the cycles the scheduler waits before the warp's next
    instruction (fixed-latency dependences are scheduled this way)."""
    lines, out = body.splitlines(), []
    for i, line in enumerate(lines[:-1]):
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* 0x[0-9a-f]+ \*/",
                     line)
        hi = re.search(r"/\* (0x[0-9a-f]+) \*/", lines[i + 1])
        if m and hi:
            out.append((int(m.group(1), 16), m.group(2).strip(),
                        (int(hi.group(1), 16) >> 41) & 0xF))
    return out


def hot_loops(body):
    """The innermost loops of a K8 kernel that walk a chunk (a hundred
    products or more): for each, its samples (five products a sample),
    and its instructions, shared-memory instructions and static stall
    cycles a sample."""
    ins = instructions(body)
    loops = []
    for addr, text, _ in ins:
        m = re.search(r"BRA\s+(?:`\(.*?\)\s*)?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    out = []
    for a, b in loops:
        if any(a <= c < d <= b and (c, d) != (a, b) for c, d in loops):
            continue                                 # not innermost
        loop = [v for v in ins if a <= v[0] <= b]
        ops = [re.match(r"(?:@!?U?P\w+\s+)?([A-Z0-9.]+)", t).group(1)
               for _, t, _ in loop]
        samples = sum(o.startswith(("FMUL", "DMUL")) for o in ops) / 5
        if samples < 20:
            continue
        out.append({
            "at": hex(a), "samples": samples,
            "instructions_a_sample": round(len(loop) / samples, 3),
            "shared_memory_a_sample": round(sum(
                o.startswith(("LDS", "STS")) for o in ops) / samples, 3),
            "stall_cycles_a_sample": round(sum(
                st for *_, st in loop) / samples, 3)})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = cs.setup_card()
    from python_audio_mastering_tpu_torch.ops import _kernels
    from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan

    kl = _kernels.library()
    section = kl.compiler_log.split("== sos_scan.cu\n", 1)[1].split(
        "\n== ", 1)[0]
    print("ptxas, sos_scan.cu:")
    for line in section.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill",
                                   "smem")):
            print("  " + line.strip())
    out = args.out or str(kl.path.parent)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "k8_sass.txt")
    funcs = sass_by_function(kl.path)
    with open(path, "w") as f:
        for name, body in funcs.items():
            f.write(f"Function : {name}\n{body}\n")
            print(f"{name}: {json.dumps(opcodes(body))}; chunk loops "
                  f"{json.dumps(hot_loops(body))}")
    print(f"SASS of {len(funcs)} K8 kernels in {path}")

    dev = cs.torch.device("cuda")
    col = cs.torch.randn((1, cs.SWEEP_SECONDS * cs.FS), device=dev) * 0.1
    sos = [cs.np.tile([[1.0, 0.5, 0.25, 1.0, -0.5, 0.25]], (4, 1))]
    clock, clock_max = cs.sm_clock_under(lambda: sos_scan(col, sos))
    print(f"SM clock under K8 {clock:.0f} MHz (max {clock_max:.0f}) "
          f"({card})")
    sweep = cs.scan_sweep(dev)
    for dtype, by_k in sweep.items():
        print(f"K8 {dtype}, one {cs.SWEEP_SECONDS} s column, ns a sample by "
              "sections: " + ", ".join(f"k={k} {v:.2f}"
                                       for k, v in by_k.items()))
    print(json.dumps({"card": card, "sm_clock_mhz": clock,
                      "sweep_ns_a_sample": sweep}))


if __name__ == "__main__":
    main()
