"""ctypes binding for the native I/O library (``native/pam_native.cpp``).

Counterpart of ``python_audio_mastering_tpu.io.native`` (host I/O, no
device code; the port keeps its own copy because importing the JAX
package imports jax).  Builds ``native/libpam_native.so`` from the
repository's ``native/`` sources with ``make`` on first use; every entry
point falls back to the numpy codec of ``io.wavio`` when there is no
toolchain.

* :func:`decode_wav` — WAV bytes → float32 ``(N, C)``;
* :func:`decode_batch` — a multithreaded album decode straight into the
  padded ``(T, N_max, C)`` array;
* :func:`encode_pcm` — parallel float → PCM16/24/32.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "probe", "decode_wav", "decode_batch", "encode_pcm",
           "load"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpam_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    if not os.path.exists(os.path.join(_NATIVE_DIR, "pam_native.cpp")):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return False


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.pam_wav_probe.restype = ctypes.c_int
        lib.pam_wav_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.pam_wav_decode.restype = ctypes.c_int
        lib.pam_wav_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.pam_pcm_encode.restype = ctypes.c_int
        lib.pam_pcm_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
        lib.pam_batch_decode.restype = ctypes.c_int
        lib.pam_batch_decode.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def probe(buf: bytes):
    """``(channels, rate, frames, bits)`` of a WAV buffer, None without the
    library; raises ``ValueError`` on a header it rejects."""
    lib = load()
    if lib is None:
        return None
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    frames = ctypes.c_int64()
    bits = ctypes.c_int32()
    rc = lib.pam_wav_probe(buf, len(buf), ctypes.byref(ch), ctypes.byref(rate),
                           ctypes.byref(frames), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"native WAV probe failed (rc={rc})")
    # untrusted input (the checks of wavio.read_wav): the C++ parser clamps
    # sizes and rejects ch == 0, the wrapper rejects the rest
    if rate.value <= 0:
        raise ValueError(f"invalid sample rate {rate.value}")
    if ch.value > 1024:
        raise ValueError(f"implausible channel count {ch.value}")
    return ch.value, rate.value, frames.value, bits.value


def decode_wav(buf: bytes):
    """WAV bytes → ``(float32 (N, C), rate)`` via the native decoder."""
    lib = load()
    if lib is None:
        from python_audio_mastering_tpu_torch.io import wavio

        return wavio.read_wav(buf)
    ch, rate, frames, _ = probe(buf)
    out = np.empty((frames, ch), dtype=np.float32)
    rc = lib.pam_wav_decode(buf, len(buf),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"native WAV decode failed (rc={rc})")
    return out, rate


def decode_batch(buffers, pad_multiple: int = 1, threads: int | None = None):
    """Decode WAV byte buffers concurrently → ``(batch (T, N_max, C),
    lengths (T,), rate)``, the album fast path (one channel count)."""
    lib = load()
    if lib is None:
        from python_audio_mastering_tpu_torch.io import wavio
        from python_audio_mastering_tpu_torch.parallel.batch import pad_tracks

        decoded = [wavio.read_wav(b) for b in buffers]
        batch, lengths = pad_tracks([d[0] for d in decoded],
                                    multiple=pad_multiple)
        return batch, lengths, decoded[0][1]

    infos = [probe(b) for b in buffers]
    ch, rate = infos[0][0], infos[0][1]
    for i, info in enumerate(infos):
        if info[0] != ch:
            raise ValueError(f"track {i}: channel mismatch {info[0]} != {ch}")
    n_max = max(i[2] for i in infos)
    n_max = -(-n_max // pad_multiple) * pad_multiple
    t = len(buffers)
    out = np.empty((t, n_max, ch), dtype=np.float32)
    lengths = np.empty((t,), dtype=np.int64)
    buf_ptrs = (ctypes.c_char_p * t)(*buffers)
    lens = (ctypes.c_size_t * t)(*[len(b) for b in buffers])
    threads = threads or min(t, os.cpu_count() or 1)
    rc = lib.pam_batch_decode(
        buf_ptrs, lens, t, ch, n_max,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), threads)
    if rc != 0:
        raise ValueError(f"native batch decode failed (rc={rc})")
    return out, lengths, rate


def encode_pcm(audio: np.ndarray, sample_width: int = 2,
               threads: int | None = None) -> bytes:
    """float32 interleaved → little-endian PCM bytes (parallel)."""
    lib = load()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if lib is None:
        from python_audio_mastering_tpu_torch.io import wavio

        ints = wavio.float_to_pcm(audio.reshape(-1), sample_width)
        if sample_width == 3:
            return wavio._pack_pcm24(ints)
        return ints.astype("<i%d" % sample_width).tobytes()
    out = np.empty(audio.size * sample_width, dtype=np.uint8)
    rc = lib.pam_pcm_encode(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), audio.size,
        sample_width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads or (os.cpu_count() or 1))
    if rc != 0:
        raise ValueError(f"native PCM encode failed (rc={rc})")
    return out.tobytes()
