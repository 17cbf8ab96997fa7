"""The tensor-core kernels K1-K4 on the card: where a tile's time goes.

    python3 scripts/band_probe.py [--out DIR]

Builds ``csrc/band_energies.cu`` (K2), ``csrc/band_gain_apply.cu`` (K3),
``csrc/front_chain.cu`` (K1) and ``csrc/kweight_cells.cu`` (K4) from this
checkout, as they are and in variants made by editing a copy of the
sources (each edit is anchored on the source's text and fails loudly when
the source has moved on; a variant that does not build is left out, its
compiler errors printed), and times each at the main path's shapes
(``chip_smoke.main_path_operands``: the 180 s stereo track, L = 384, hop
8; K1 with the mono output, K4 on the mono rows at h = 6, also at the
streamed chunk) with CUDA events, with the variants' errors against the
plain twins:

  as_is        the kernels as the port builds them
  clocks       as_is with clock64() spans summed over every CTA's first
               consumer and epilogue thread: a tile's products, its waits
               for a full stage and for the epilogue, and the epilogue's
               work and wait, in cycles a tile (K3, K1, K4)
  no_epilogue  the epilogue warps skip their work (the consumers still
               hand every tile over): the products alone
  mma_only     no_epilogue, and the producer arrives on the full barriers
               without copying: the MMAs on whatever the ring holds
  data_only    no_epilogue, and the consumers issue no MMA: the copies
               alone
  exciter_in_place  K1 with its exciter applied in place to each landed
               stage by the producer warpgroup's other three warps (behind
               a third barrier a stage) instead of by the consumers to the
               fragments they load
  no_exciter   K1 without its exciter (the consumers split the raw
               signal): the most that any placement of it could save
  k4_whole_row K4 with a span of the whole row (one item a row tile, 162
               at 180 s, 23 at the streamed chunk) instead of lcm(h, 64)
               columns (324 and 46): the item width
  k4_stages3   K4 with a ring of three stages instead of four

and prints each variant's ptxas report and its SASS census of the four
kernels (HGMMA, HMMA, spills), with the first HGMMA line (the as-is SASS
written whole to ``DIR/band_sass.txt`` with ``--out``).  Needs an NVIDIA
GPU and ``cuobjdump`` beside ``nvcc``.
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
K1, K4 = "front_chain.cu", "kweight_cells.cu"
KERNELS = ("band_energies", "band_gain_apply", "front_chain", "kweight_cells")


def _clock_reader(name):
    """A C entry that clears (reset) or reads the clock sums of one source
    (each translation unit has its own copy of the header's counters)."""
    return (f'extern "C" int pam_probe_clocks_{name}(unsigned long long* h, '
            f'int reset) {{\n'
            '  unsigned long long z[8] = {0};\n'
            '  return (int)(reset ? cudaMemcpyToSymbol(pam::wgb::g_prof, z, '
            '64)\n'
            '                     : cudaMemcpyFromSymbol(h, pam::wgb::g_prof, '
            '64));\n}\n')


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
     _clock_reader("band_gain_apply") + 'extern "C" int pam_band_gain_apply('),
    (K1, 'extern "C" int pam_front_chain(',
     _clock_reader("front_chain") + 'extern "C" int pam_front_chain('),
    (K4, 'extern "C" int pam_kweight_cells(',
     _clock_reader("kweight_cells") + 'extern "C" int pam_kweight_cells('),
]
NO_EPILOGUE = [(H, "      epi.tile(t);\n", "      if (g.C < 0) epi.tile(t);\n")]
NO_COPIES = [(H, "        mbar_arrive_tx(full + stage, tx);\n"
                 "        bulk_load(st, pk + (size_t)kt * (Sh::kBBytes / 4), "
                 "Sh::kBBytes,\n"
                 "                  full + stage);\n"
                 "        tma_load_3d(st + Sh::kBBytes, xmap, kt * kK, b0, 0, "
                 "full + stage);",
              "        mbar_arrive(full + stage);")]
NO_MMA = [(H, "          wgmma_tf32(acc, asm_[s], b_desc(bb + k8));\n"
              "          wgmma_tf32(acc, ab[s], b_desc(bb + Sh::kPartBytes + "
              "k8));\n"
              "          wgmma_tf32(acc, ab[s], b_desc(bb + k8));",
           "          if (g.C < 0) {\n"
           "            wgmma_tf32(acc, asm_[s], b_desc(bb + k8));\n"
           "            wgmma_tf32(acc, ab[s], b_desc(bb + Sh::kPartBytes + "
           "k8));\n"
           "            wgmma_tf32(acc, ab[s], b_desc(bb + k8));\n"
           "          }")]
# front_chain (the one-filter kernel of N = 128) with the exciter applied in
# place to each landed stage by the producer warpgroup's other three warps,
# handed to the consumers through a third barrier a stage (the producer's
# warpgroup at 32 registers, what the consumers' increase leaves)
TRANSFORM = """constexpr int kTransformers = 96;  // the producer warpgroup's warps 1-3
// The transformers (in place): every stage the producer lands, in the
// consumers' order, gets xop applied to its A tile in place (16 bytes a
// thread at a time), then is handed to the consumers through its ready
// barrier (a warp of each transformer).  A stage is refilled only after
// the consumers release it, so a transformer cannot fall a phase behind.
template <class Sh, class XOp>
__device__ __forceinline__ void transform(const Geometry& g, uint8_t* smem,
                                          uint64_t* full, uint64_t* ready,
                                          XOp xop) {
  const int tid = threadIdx.x - 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    int b0, sp;
    item_at(g, it, b0, sp);
    for (int tt = 0; tt < g.tiles; ++tt) {
      const int nk = Sh::kQ * (sp * g.tiles + tt + 1);
      for (int k = 0; k < nk; ++k) {
        mbar_wait(full + stage, phase);
        float4* a =
            reinterpret_cast<float4*>(smem + stage * Sh::kStageBytes +
                                      Sh::kBBytes);
#pragma unroll 1
        for (int i = tid; i < kABytes / 16; i += kTransformers) {
          float4 v = a[i];
          v.x = xop(v.x);
          v.y = xop(v.y);
          v.z = xop(v.z);
          v.w = xop(v.w);
          a[i] = v;
        }
        // the stage is refilled by the async proxy (TMA) after this
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(ready + stage);
        if (++stage == Sh::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

"""
IN_PLACE = [
    (H, "// The one-filter kernel body: roles, then the ring.",
     TRANSFORM + "// The one-filter kernel body: roles, then the ring."),
    (H, "  static constexpr int kSmemBytes = kBarOff + Sh::kBars * 8 + 1024;",
     "  static constexpr int kSmemBytes =\n"
     "      kBarOff + (Sh::kBars + Stages) * 8 + 1024;"),
    (H, "  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBarOff);",
     "  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBarOff);\n"
     "  constexpr bool kInPlace = Sh::kN == 128;  // front_chain's shape\n"
     "  uint64_t* ready = full + 2 * Sh::kStages + 2;\n"
     "  if (kInPlace && threadIdx.x == 0)\n"
     "    for (int s = 0; s < Sh::kStages; ++s)\n"
     "      mbar_init(ready + s, kTransformers / 32);"),
    (H, "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\" ::\"n\"("
        "kProducerRegs));\n"
        "    if (threadIdx.x == 0) produce<Sh>(xmap, packed, g, smem, full, "
        "empty);",
     "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\" ::\"n\"("
     "kInPlace ? 32 : kProducerRegs));\n"
     "    if (threadIdx.x == 0) produce<Sh>(xmap, packed, g, smem, full, "
     "empty);\n"
     "    if constexpr (kInPlace)\n"
     "      if (threadIdx.x >= 32) transform<Sh>(g, smem, full, ready, xop);"),
    (H, "    consume<Sh>(g, smem, full, empty, tile_full, tile_empty, xop);",
     "    if constexpr (kInPlace)\n"
     "      consume<Sh>(g, smem, ready, empty, tile_full, tile_empty, "
     "NoX{});\n"
     "    else\n"
     "      consume<Sh>(g, smem, full, empty, tile_full, tile_empty, xop);"),
]
NO_EXCITER = [
    (K1, "wgb::one_product<FrontShape>(&xmap, packed, wt, s_in, g, exc, "
         "epi);",
     "wgb::one_product<FrontShape>(&xmap, packed, wt, s_in, g, wgb::NoX{}, "
     "epi);")]
WHOLE_ROW = [(K4, "geometry(C, nb, L, S, h, h / a * Sh::kN, g,",
              "geometry(C, nb, L, S, h, L, g,")]
STAGES3 = [(K4, "wgb::One<64, 4, kCellsEpiBytes,",
            "wgb::One<64, 3, kCellsEpiBytes,")]
VARIANTS = {"as_is": [], "clocks": PROF, "no_epilogue": NO_EPILOGUE,
            "mma_only": NO_EPILOGUE + NO_COPIES,
            "data_only": NO_EPILOGUE + NO_MMA,
            "exciter_in_place": IN_PLACE, "no_exciter": NO_EXCITER,
            "k4_whole_row": WHOLE_ROW, "k4_stages3": STAGES3}


def build(name, edits, work):
    """K1-K4 with ``edits`` applied to a copy of csrc, as a ctypes
    library; returns ``(lib, ptxas report, library path)``, or None (the
    compiler's errors printed) where the variant does not build."""
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
    for f in (K3, K2, K1, K4):
        obj = os.path.join(src, f + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_kernels._NVCC_FLAGS, "-c", "-I", src, "-o", obj,
             os.path.join(src, f)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        print(f"{name}: nvcc failed, variant left out\n" + "\n".join(
            line for line in "\n".join(logs).splitlines()
            if "error" in line)[:4000])
        return None
    so = os.path.join(src, "libband.so")
    subprocess.run([nvcc, *_kernels._ARCH, "-shared", "-o", so, *objs],
                   check=True)
    lib = ctypes.CDLL(so)
    for k in KERNELS:
        getattr(lib, f"pam_{k}").argtypes = _kernels._SIGNATURES[f"pam_{k}"]
        getattr(lib, f"pam_{k}").restype = ctypes.c_int
    report = [line.strip() for line in "\n".join(logs).splitlines()
              if "registers" in line or "spill" in line]
    return lib, report, so


def sass_census(so):
    """``{kernel: (HGMMA, HMMA, STL + LDL, first HGMMA line)}`` of K1-K4
    and the library's SASS."""
    from python_audio_mastering_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0]
        kernel = next((k for k in KERNELS if f"{k}_kernel" in name), None)
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
    from python_audio_mastering_tpu_torch.ops.waveshaper import exciter_coefs

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
    # K1: the main path's EQ; K4: the mono rows and the streamed chunk
    x1, s1, t1, w1, sat, width = o.k1_args
    c1, s1n = x1.shape[0], s1.shape[2]
    dry, wet, drive = exciter_coefs(sat)
    p1, wt1 = cmb.packed_operator(t1, cmb._FRONT_COLS), w1.T.contiguous()
    y1_ref, m1_ref = cmb.front_chain_ref(*o.k1_args, emit_mono=True)
    y1, m1 = torch.empty_like(y1_ref), torch.empty_like(m1_ref)
    h4 = cs.K4_HOPS[0]
    p4 = cmb.packed_operator(o.kw.t, cmb._CELLS_COLS)
    wt4 = o.kw.w.T.contiguous()
    k4_rows = {"": (o.mono, o.s_kw), "_chunk": o.k4_chunk}
    k4_ref = {k: cmb.kweight_cells_ref(*v, o.kw.t, o.kw.w, h4)
              for k, v in k4_rows.items()}
    k4_out = {k: torch.empty_like(v) for k, v in k4_ref.items()}
    ptr = cmb._ptr
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as work:
        built = {n: b for n, b in ((n, build(n, e, work))
                                   for n, e in VARIANTS.items())
                 if b is not None}
        res = {}

        def calls(lib):
            def k3(m=True):
                return lib.pam_band_gain_apply(
                    ptr(xr), ptr(packed), ptr(wt2), ptr(s_lp), ptr(s_hp),
                    ptr(cols), ptr(y), ptr(mono) if m else None, c, nb, L,
                    s, hop, stream)

            def k2():
                return lib.pam_band_energies(
                    ptr(xr), ptr(packed), ptr(wt2), ptr(s_lp), ptr(s_hp),
                    ptr(out), c, nb, L, s, hop, stream)

            def k1():
                return lib.pam_front_chain(
                    ptr(x1), ptr(p1), ptr(wt1), ptr(s1), ptr(y1), ptr(m1),
                    c1, nb, L, s1n, dry, wet, drive, float(width), stream)

            def k4(key=""):
                xk, sk = k4_rows[key]
                return lib.pam_kweight_cells(
                    ptr(xk), ptr(p4), ptr(wt4), ptr(sk), ptr(k4_out[key]),
                    1, xk.shape[1], L, sk.shape[2], h4, stream)

            return {"K3_ms": k3, "K3_no_mono_ms": lambda: k3(False),
                    "K2_ms": k2, "K1_ms": k1, "K4_ms": k4,
                    "K4_chunk_ms": lambda: k4("_chunk")}

        def rel(got, ref):
            return ((got - ref).abs().max() / ref.abs().max()).item()

        for rnd in range(2):  # in turns: A B C .. then .. C B A
            order = list(built) if rnd == 0 else list(built)[::-1]
            for name in order:
                r = res.setdefault(name, {})
                for what, fn in calls(built[name][0]).items():
                    if fn() != 0:
                        raise SystemExit(f"{name}: {what} launch failed")
                    torch.cuda.synchronize()
                    r.setdefault(what, []).append(statistics.median(
                        cs.cuda_ms(fn, reps=20) for _ in range(3)))
                torch.cuda.synchronize()
                r["K3_err"] = rel(y, y_ref)
                r["K3_mono_err"] = rel(mono, m_ref)
                r["K2_err"] = rel(out, e_ref)
                r["K1_err"] = (y1 - y1_ref).abs().max().item()
                r["K1_mono_err"] = (m1 - m1_ref).abs().max().item()
                for key in k4_rows:
                    r[f"K4{key}_err"] = rel(k4_out[key], k4_ref[key])
        lib = built["clocks"][0]
        fns = calls(lib)
        buf = (ctypes.c_ulonglong * 8)()
        for kernel, what, run in (
                ("band_gain_apply", "K3 no mono", fns["K3_no_mono_ms"]),
                ("band_gain_apply", "K3 mono", fns["K3_ms"]),
                ("front_chain", "K1 mono", fns["K1_ms"]),
                ("kweight_cells", "K4 h=6", fns["K4_ms"]),
                ("kweight_cells", "K4 h=6, streamed chunk",
                 fns["K4_chunk_ms"])):
            reader = getattr(lib, f"pam_probe_clocks_{kernel}")
            reader(buf, 1)
            run()
            torch.cuda.synchronize()
            reader(buf, 0)
            v, tiles = list(buf), max(buf[4], 1)
            print(json.dumps({"cycles_a_tile": {
                "kernel": what, "tiles": v[4],
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
