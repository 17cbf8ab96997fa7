"""Command-line interface of the port.

    python -m python_audio_mastering_tpu_torch.cli master in.wav out.wav \
        --preset techno --saturation 20 --width 1.3 --lufs -14 --multiband
    python -m python_audio_mastering_tpu_torch.cli batch in_dir/ out_dir/ --preset pop
    python -m python_audio_mastering_tpu_torch.cli album in_dir/ out_dir/ --transfer pcm16
    python -m python_audio_mastering_tpu_torch.cli measure track.wav
    python -m python_audio_mastering_tpu_torch.cli resample in.wav out.wav --rate 48000
    python -m python_audio_mastering_tpu_torch.cli serve --port 8080
    python -m python_audio_mastering_tpu_torch.cli automaster in.wav out.wav --reference ref.wav

Counterpart of ``python_audio_mastering_tpu.cli``: the same seven verbs,
flags and messages, over the port's engine.  Every verb runs on the card
unless ``--device cpu`` is given; without a card it fails (exit 1, or the
engine's ``ERROR:`` line).  ``--exact`` selects ``ChainConfig()`` (hop-1
detector, block 512); without it a verb takes the throughput knobs of
``ChainConfig.gpu_default``.
"""

from __future__ import annotations

import argparse
import sys


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs "
                        "the kernels' plain versions)")


def _add_settings_args(p):
    p.add_argument("--preset", choices=["techno", "dubstep", "pop", "rock"],
                   help="EQ genre preset")
    p.add_argument("--saturation", type=float, default=0.0, help="0..100 %%")
    p.add_argument("--bass-boost", type=float, default=None, help="-6..6 dB")
    p.add_argument("--mid-cut", type=float, default=None, help="0..6 dB")
    p.add_argument("--presence-boost", type=float, default=None, help="-6..6 dB")
    p.add_argument("--treble-boost", type=float, default=None, help="-6..6 dB")
    p.add_argument("--width", type=float, default=1.0, help="stereo width 0..2")
    p.add_argument("--lufs", type=float, default=-14.0,
                   help="target integrated loudness (use --no-lufs to skip)")
    p.add_argument("--no-lufs", action="store_true")
    p.add_argument("--multiband", action="store_true",
                   help="enable the 3-band compressor")
    for band in ("low", "mid", "high"):
        p.add_argument(f"--{band}-thresh", type=float, default=None)
        p.add_argument(f"--{band}-ratio", type=float, default=None)
    p.add_argument("--output-rate", type=int, default=None,
                   help="resample the mastered output to this rate in Hz")
    p.add_argument("--variant", choices=["worker", "legacy"], default="worker")
    p.add_argument("--exact", action="store_true",
                   help="exact contract mode, ChainConfig() (slower; "
                        "default is the throughput config)")
    p.add_argument("--quality", action="store_true",
                   help="lookahead true-peak brickwall limiter instead of "
                        "the reference soft knee")
    p.add_argument("--dither", action="store_true",
                   help="TPDF dither at the 16-bit export quantization")
    _add_device_arg(p)


def _settings_from_args(args) -> dict:
    s = {"saturation": args.saturation, "width": args.width,
         "lufs": None if args.no_lufs else args.lufs,
         "multiband": args.multiband}
    if args.preset:
        s["preset"] = args.preset
    for k in ("bass_boost", "mid_cut", "presence_boost", "treble_boost",
              "low_thresh", "low_ratio", "mid_thresh", "mid_ratio",
              "high_thresh", "high_ratio"):
        v = getattr(args, k)
        if v is not None:
            s[k] = v
    if getattr(args, "output_rate", None):
        s["output_sample_rate"] = args.output_rate
    if getattr(args, "dither", False):
        s["dither"] = True
    return s


def _config_from_args(args, sample_rate):
    import dataclasses

    from python_audio_mastering_tpu_torch.config import ChainConfig

    if args.exact:
        cfg = ChainConfig(sample_rate=sample_rate, variant=args.variant)
    else:
        cfg = dataclasses.replace(ChainConfig.gpu_default(
            sample_rate=sample_rate), variant=args.variant)
    if getattr(args, "quality", False):
        cfg = dataclasses.replace(cfg, limiter_mode="lookahead_truepeak")
    return cfg


def _device(args):
    """The requested device, or None after printing why it is missing."""
    from python_audio_mastering_tpu_torch.models.chain import require_device

    try:
        return require_device(args.device, f"cli {args.cmd}")
    except RuntimeError as e:
        print(f"ERROR: {e}")
        return None


def cmd_master(args):
    from python_audio_mastering_tpu_torch import engine
    from python_audio_mastering_tpu_torch.io import wavio

    try:
        _, fs = wavio.read_audio(args.input)
    except (OSError, ValueError) as e:
        print(f"ERROR: cannot read {args.input}: {e}")
        return 1
    settings = _settings_from_args(args)
    settings["input_file"] = args.input
    settings["output_file"] = args.output
    ok = engine.process_audio(settings, status_callback=print,
                              config=_config_from_args(args, fs),
                              device=args.device)
    return 0 if ok else 1


def cmd_batch(args):
    from python_audio_mastering_tpu_torch import engine

    n = engine.batch_process_audio(_settings_from_args(args), args.input_dir,
                                   args.output_dir, status_callback=print,
                                   device=args.device)
    return 0 if n > 0 else 1


def cmd_measure(args):
    import torch

    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import loudness, meters

    device = _device(args)
    if device is None:
        return 1
    audio, fs = wavio.read_audio(args.input)
    x = torch.from_numpy(audio).to(device)
    lufs = float(loudness.integrated_loudness(x, fs))
    mono = float(loudness.integrated_loudness(x, fs,
                                              downmix="reference_mono_mean"))
    peak = float(abs(audio).max())
    tp = float(meters.true_peak_db(x, fs))
    lra = float(meters.loudness_range(x, fs))
    print(f"{args.input}: {lufs:.2f} LUFS (BS.1770 stereo), "
          f"{mono:.2f} LUFS (mono-mean), LRA {lra:.1f} LU, "
          f"sample peak {peak:.4f}, true peak {tp:.2f} dBTP")
    return 0


def cmd_album(args):
    """Master a folder as ONE batched chunked run (the album path,
    ``parallel.batch.master_album_streamed``): unlike ``batch``, which
    loops file by file as the reference GUI does."""
    import os

    from python_audio_mastering_tpu_torch import engine
    from python_audio_mastering_tpu_torch.config import MasteringParams
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.parallel.batch import (
        master_album_streamed,
    )

    try:
        files = sorted(
            f for f in os.listdir(args.input_dir)
            if os.path.splitext(f)[1].lower() in engine.AUDIO_EXTENSIONS)
    except OSError as e:
        print(f"ERROR: cannot read input folder: {e}")
        return 1
    if not files:
        print("No audio files found in the input folder.")
        return 1
    device = _device(args)
    if device is None:
        return 1

    loaded, names = [], []
    for name in files:
        try:
            loaded.append(wavio.read_audio(os.path.join(args.input_dir, name)))
            names.append(name)
        except (OSError, ValueError) as e:
            # skip unreadable files and master the rest (the `batch` policy)
            print(f"  Skipping {name}: {e}")
    if not loaded:
        print("No readable audio files in the input folder.")
        return 1
    tracks, fs_album = engine.conform_album_tracks(loaded, names, print,
                                                   device)

    settings = _settings_from_args(args)
    params = MasteringParams.from_settings(settings)
    cfg = _config_from_args(args, fs_album)
    outs, measured, meters = master_album_streamed(
        tracks, params, cfg, progress_cb=print, transfer=args.transfer,
        return_meters=True, device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    for name, out, lufs, m in zip(names, outs, measured, meters):
        out, out_fs = engine._maybe_resample(out, fs_album, settings, print,
                                             device)
        base, ext = os.path.splitext(name)
        dst = os.path.join(args.output_dir, f"{base}_mastered{ext}")
        wavio.write_audio(dst, out, out_fs,
                          dither=bool(settings.get("dither")))
        s = engine.meters_summary(m)
        stats = " · ".join(
            f"{v} {u}" for v, u in
            ((s["integrated_lufs"], "LUFS"), (s["lra_lu"], "LU LRA"),
             (s["true_peak_dbtp"], "dBTP")) if v is not None)
        extra = f" ({stats})" if stats else ""
        print(f"  {dst}{extra}")
    print(f"Album processing complete! {len(names)} files mastered.")
    return 0


def cmd_resample(args):
    import numpy as np
    import torch

    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import resample as rs

    try:
        audio, fs = wavio.read_audio(args.input)
    except (OSError, ValueError) as e:
        print(f"ERROR: cannot read {args.input}: {e}")
        return 1
    if fs == args.rate:
        print(f"{args.input} is already at {fs} Hz")
        out = np.asarray(audio)
    else:
        device = _device(args)
        if device is None:
            return 1
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(device)
        out = rs.resample(x, fs, args.rate).cpu().numpy()
        print(f"Resampled {fs} -> {args.rate} Hz "
              f"({audio.shape[0]} -> {out.shape[0]} frames)")
    # extension-aware container (float32 WAV intermediate for non-WAV), so
    # `resample in.flac out.flac` produces a real flac, not RIFF bytes
    wavio.write_audio(args.output, out, args.rate,
                      sample_width={"16": 2, "24": 3, "32": 4,
                                    "float": 4}[args.width],
                      float_format=args.width == "float")
    return 0


def cmd_serve(args):
    import os

    os.environ.setdefault("PORT", str(args.port))
    if args.blob_root:
        os.environ["PAM_BLOB_ROOT"] = args.blob_root
    from python_audio_mastering_tpu_torch.serving.backend import main as serve_main

    serve_main(device=args.device)
    return 0


def cmd_automaster(args):
    import numpy as np

    from python_audio_mastering_tpu_torch import MasteringParams, master
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.models import automaster

    device = _device(args)
    if device is None:
        return 1
    audio, fs = wavio.read_audio(args.input)
    ref, ref_fs = wavio.read_audio(args.reference)
    cfg = _config_from_args(args, fs)
    model = automaster.AutoMasterModel(config=cfg, target_lufs=args.lufs,
                                       device=device)
    target = automaster.spectral_profile(model.as_audio(ref), ref_fs)
    params, losses = automaster.fit(
        model, audio.astype(np.float32), target, steps=args.steps,
        callback=lambda i, l: print(f"step {i}: loss {l:.5f}"))
    print("fitted settings:", {k: round(v, 2) if isinstance(v, float) else v
                               for k, v in params.to_settings().items()})
    fitted = MasteringParams.from_settings(params.to_settings())
    out = master(audio.astype(np.float32), fitted, cfg, device=device)
    wavio.write_audio(args.output, out.cpu().numpy(), fs)
    print(f"Processing complete! Saved to {args.output}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python_audio_mastering_tpu_torch",
                                 description="audio mastering on a GPU "
                                             "(PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("master", help="master a single file")
    p.add_argument("input")
    p.add_argument("output")
    _add_settings_args(p)
    p.set_defaults(fn=cmd_master)

    p = sub.add_parser("batch", help="master every audio file in a folder")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    _add_settings_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("measure", help="measure integrated loudness")
    p.add_argument("input")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("album",
                       help="master a folder as one batched device call")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--transfer", choices=["float32", "pcm16"],
                   default="float32",
                   help="host-device link format (pcm16 halves link bytes "
                        "at a 16-bit noise floor; float32 is lossless)")
    _add_settings_args(p)
    p.set_defaults(fn=cmd_album)

    p = sub.add_parser("resample",
                       help="convert a file's sample rate (polyphase)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--rate", type=int, required=True,
                   help="target sample rate in Hz (e.g. 48000)")
    p.add_argument("--width", choices=["16", "24", "32", "float"],
                   default="16", help="output WAV bit depth")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_resample)

    p = sub.add_parser("serve", help="run the local job API + worker")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--blob-root", default=None)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("automaster",
                       help="fit mastering params to a reference track")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--reference", required=True)
    p.add_argument("--steps", type=int, default=40)
    _add_settings_args(p)
    p.set_defaults(fn=cmd_automaster)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
