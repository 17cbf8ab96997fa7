"""The band kernels K2 and K3 on the card: where a tile's time goes.

    python3 scripts/band_probe.py [--out DIR]

Builds ``csrc/band_energies.cu`` and ``csrc/band_gain_apply.cu`` from this
checkout, as they are and in variants made by editing a copy of the
sources (each edit is anchored on the source's text and fails loudly when
the source has moved on), and times each at the main path's shapes
(``chip_smoke.main_path_operands``: the 180 s stereo track, L = 384, hop
8) with CUDA events, K2 and K3 (with and without the mono output), with
the variants' errors against the plain twins:

  as_is       the kernels as the port builds them
  clocks      as_is with clock64() spans summed over every CTA's first
              consumer and epilogue thread: a tile's products, its waits
              for a full stage and for the epilogue, and the epilogue's
              work and wait, in cycles a tile (K3)
  no_epilogue the epilogue warps skip their work (the consumers still hand
              every tile over)
  mma_only    no_epilogue, and the producer arrives on the full barriers
              without copying: the MMAs on whatever the ring holds
  data_only   no_epilogue, and the consumers issue no MMA: the copies alone

and prints each variant's ptxas report and its SASS census of the band
kernels (HGMMA, HMMA, spills), with the first HGMMA line (written whole
to ``DIR/band_sass.txt`` with ``--out``).  Needs an NVIDIA GPU and
``cuobjdump`` beside ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the card's setup and the operands)

H, K2, K3 = "tf32_wgmma.cuh", "band_energies.cu", "band_gain_apply.cu"
PROF = [
    (H, "namespace pam {\nnamespace wgb {\n",
     "namespace pam {\nnamespace wgb {\n"
     "static __device__ unsigned long long g_prof[8];\n"),
    (H, "      for (int kt = 0; kt < nk; ++kt) {\n"
        "        mbar_wait(full + stage, phase);",
     "      long long c0 = clock64();\n"
     "      for (int kt = 0; kt < nk; ++kt) {\n"
     "        long long w0 = clock64();\n"
     "        mbar_wait(full + stage, phase);\n"
     "        if (ctid == 0) atomicAdd(&g_prof[1], "
     "(unsigned long long)(clock64() - w0));"),
    (H, "      mbar_wait(tile_empty, (done & 1) ^ 1);",
     "      long long c1 = clock64();\n"
     "      mbar_wait(tile_empty, (done & 1) ^ 1);\n"
     "      if (ctid == 0) {\n"
     "        atomicAdd(&g_prof[0], (unsigned long long)(c1 - c0));\n"
     "        atomicAdd(&g_prof[2], (unsigned long long)(clock64() - c1));\n"
     "        atomicAdd(&g_prof[4], 1ull);\n"
     "      }"),
    (H, "      mbar_wait(tile_full, tphase);\n      epi.tile(t);",
     "      long long f0 = clock64();\n"
     "      mbar_wait(tile_full, tphase);\n"
     "      long long f1 = clock64();\n"
     "      epi.tile(t);\n"
     "      if (etid == 0) {\n"
     "        atomicAdd(&g_prof[5], (unsigned long long)(f1 - f0));\n"
     "        atomicAdd(&g_prof[3], (unsigned long long)(clock64() - f1));\n"
     "      }"),
    (K3, 'extern "C" int pam_band_gain_apply(',
     'extern "C" int pam_probe_clocks(unsigned long long* h, int reset) {\n'
     '  unsigned long long z[8] = {0};\n'
     '  return (int)(reset ? cudaMemcpyToSymbol(pam::wgb::g_prof, z, 64)\n'
     '                     : cudaMemcpyFromSymbol(h, pam::wgb::g_prof, 64));'
     '\n}\n'
     'extern "C" int pam_band_gain_apply('),
]
NO_EPILOGUE = [(H, "      epi.tile(t);\n", "      if (g.C < 0) epi.tile(t);\n")]
NO_COPIES = [(H, "        mbar_arrive_tx(full + stage, tx);\n"
                 "        bulk_load(st, pk + (size_t)kt * (kBBytes / 4), "
                 "kBBytes,\n"
                 "                  full + stage);\n"
                 "        tma_load_3d(st + kBBytes, xmap, kt * kK, b0, 0, "
                 "full + stage);",
              "        mbar_arrive(full + stage);")]
NO_MMA = [(H, "          wgmma_tf32(acc, asm_[s], b_desc(bb + k8));\n"
              "          wgmma_tf32(acc, ab[s], b_desc(bb + kPartBytes + "
              "k8));\n"
              "          wgmma_tf32(acc, ab[s], b_desc(bb + k8));",
           "          if (g.C < 0) {\n"
           "            wgmma_tf32(acc, asm_[s], b_desc(bb + k8));\n"
           "            wgmma_tf32(acc, ab[s], b_desc(bb + kPartBytes + "
           "k8));\n"
           "            wgmma_tf32(acc, ab[s], b_desc(bb + k8));\n"
           "          }")]
VARIANTS = {"as_is": [], "clocks": PROF, "no_epilogue": NO_EPILOGUE,
            "mma_only": NO_EPILOGUE + NO_COPIES,
            "data_only": NO_EPILOGUE + NO_MMA}


def build(name, edits, work):
    """The band kernels of ``edits`` applied to a copy of csrc, as a
    ctypes library; returns ``(lib, ptxas report, library path)``."""
    from python_audio_mastering_tpu_torch.ops import _kernels

    src = os.path.join(work, name)
    shutil.copytree(_kernels._SRC_DIR, src)
    for f, old, new in edits:
        path = os.path.join(src, f)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"{name}: the anchor in {f} has moved: "
                             f"{old[:60]!r}")
        open(path, "w").write(text.replace(old, new))
    nvcc = _kernels._nvcc_path()
    objs, procs = [], []
    for f in (K3, K2):
        obj = os.path.join(src, f + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_kernels._NVCC_FLAGS, "-c", "-I", src, "-o", obj,
             os.path.join(src, f)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit(f"{name}: nvcc failed\n" + "\n".join(logs))
    so = os.path.join(src, "libband.so")
    subprocess.run([nvcc, *_kernels._ARCH, "-shared", "-o", so, *objs],
                   check=True)
    lib = ctypes.CDLL(so)
    for fn in ("pam_band_gain_apply", "pam_band_energies"):
        getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    report = [line.strip() for line in "\n".join(logs).splitlines()
              if "registers" in line or "spill" in line]
    return lib, report, so


def sass_census(so):
    """``{kernel: (HGMMA, HMMA, STL + LDL, first HGMMA line)}`` and the
    band kernels' SASS."""
    from python_audio_mastering_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0]
        kernel = next((k for k in ("band_energies", "band_gain_apply")
                       if k in name), None)
        if kernel:
            hg = [ln.strip() for ln in fn.splitlines() if "HGMMA" in ln]
            out[kernel] = (len(hg), len(re.findall(r"\bHMMA\b", fn)),
                           len(re.findall(r"\b(?:STL|LDL)\b", fn)),
                           hg[0] if hg else "")
    return out, text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = cs.setup_card()
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    o = cs.main_path_operands(torch.device("cuda"))
    hop = o.hop
    xr, s_lp, s_hp = o.band_args[:3]
    c, nb, L = xr.shape
    s = s_lp.shape[2]
    _, wt2 = cmb.crossover_operands(*o.sos, L, xr.device)
    packed = cmb.crossover_packed(*o.sos, L, xr.device)
    t = nb * (L // hop)
    gen = torch.Generator(device=xr.device).manual_seed(0)
    cols = 0.5 + 0.5 * torch.rand((3, t), generator=gen, device=xr.device)
    y_ref, m_ref = cmb.band_gain_apply_ref(xr, s_lp, s_hp, cols, *o.sos,
                                           hop=hop, emit_mono=True)
    e_ref = cmb.band_energies_ref(xr, s_lp, s_hp, *o.sos, hop=hop)
    y, mono = torch.empty_like(xr), torch.empty_like(m_ref)
    out = torch.empty_like(e_ref)
    ptr = cmb._ptr
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as work:
        built = {n: build(n, e, work) for n, e in VARIANTS.items()}
        res = {}
        for rnd in range(2):  # in turns: A B C .. then .. C B A
            order = list(built) if rnd == 0 else list(built)[::-1]
            for name in order:
                lib = built[name][0]

                def k3(m=True, lib=lib):
                    return lib.pam_band_gain_apply(
                        ptr(xr), ptr(packed), ptr(wt2), ptr(s_lp),
                        ptr(s_hp), ptr(cols), ptr(y),
                        ptr(mono) if m else None, c, nb, L, s, hop, stream)

                def k2(lib=lib):
                    return lib.pam_band_energies(
                        ptr(xr), ptr(packed), ptr(wt2), ptr(s_lp),
                        ptr(s_hp), ptr(out), c, nb, L, s, hop, stream)

                r = res.setdefault(name, {})
                for what, fn in (("K3_ms", k3), ("K3_no_mono_ms",
                                                 lambda: k3(False)),
                                 ("K2_ms", k2)):
                    if fn() != 0:
                        raise SystemExit(f"{name}: {what} launch failed")
                    torch.cuda.synchronize()
                    r.setdefault(what, []).append(statistics.median(
                        cs.cuda_ms(fn, reps=20) for _ in range(3)))
                k3()
                k2()
                torch.cuda.synchronize()
                r["K3_err"] = ((y - y_ref).abs().max()
                               / y_ref.abs().max()).item()
                r["K3_mono_err"] = ((mono - m_ref).abs().max()
                                    / m_ref.abs().max()).item()
                r["K2_err"] = ((out - e_ref).abs().max()
                               / e_ref.abs().max()).item()
        lib = built["clocks"][0]
        buf = (ctypes.c_ulonglong * 8)()
        for mono_on in (False, True):
            lib.pam_probe_clocks(buf, 1)
            lib.pam_band_gain_apply(
                ptr(xr), ptr(packed), ptr(wt2), ptr(s_lp), ptr(s_hp),
                ptr(cols), ptr(y), ptr(mono) if mono_on else None, c, nb,
                L, s, hop, stream)
            torch.cuda.synchronize()
            lib.pam_probe_clocks(buf, 0)
            v, tiles = list(buf), max(buf[4], 1)
            print(json.dumps({
                "K3_cycles_a_tile": {
                    "mono": mono_on, "tiles": v[4],
                    "products": v[0] // tiles,
                    "of_which_waiting_for_a_stage": v[1] // tiles,
                    "consumers_waiting_for_the_epilogue": v[2] // tiles,
                    "epilogue_work": v[3] // tiles,
                    "epilogue_waiting_for_a_tile": v[5] // tiles}}))
        for name, (_, report, so) in built.items():
            census, text = sass_census(so)
            print(json.dumps({"variant": name, **{
                k: (round(statistics.mean(v), 4) if isinstance(v, list)
                    else v) for k, v in res[name].items()},
                "ptxas": report, "sass": census}))
            if name == "as_is" and args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, "band_sass.txt"), "w") as f:
                    f.write(text)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
