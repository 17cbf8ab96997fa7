"""Host-side WAV I/O: dependency-free RIFF/WAVE reader and writer.

Counterpart of ``python_audio_mastering_tpu.io.wavio`` for WAV files (PCM
8/16/24/32-bit and IEEE float32/64), pure numpy.  Audio is ``float32
(N, C)`` in [-1, 1].  Other containers (through ffmpeg) and the native C++
PCM encoder are not ported yet: :func:`read_audio` / :func:`write_audio`
raise ``NotImplementedError`` for non-WAV paths.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

__all__ = ["read_wav", "write_wav", "pcm_to_float", "float_to_pcm",
           "read_audio", "write_audio"]

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def pcm_to_float(data: np.ndarray, sample_width: int) -> np.ndarray:
    """Integer PCM → float32 in [-1, 1): ``x / 2**(8*width-1)``.

    Matches the reference's scaling (engine:117-121).
    """
    return data.astype(np.float32) / float(2 ** (8 * sample_width - 1))


def float_to_pcm(data: np.ndarray, sample_width: int,
                 dither: bool = False, dither_seed: int | None = None
                 ) -> np.ndarray:
    """float [-1, 1] → integer PCM with clipping (engine:123-126 semantics,
    but honouring ``sample_width`` instead of hardcoding int16).

    ``dither=True`` adds 1-LSB-peak TPDF dither before quantization (the
    standard mastering practice for ≤16-bit export that the reference
    skips): quantization error decorrelates from the signal — low-level
    material keeps its detail under a flat ~-93 dBFS noise floor instead
    of harmonic truncation distortion.  ``dither_seed`` makes the noise
    reproducible (tests)."""
    scale = float(2 ** (8 * sample_width - 1))
    x = np.asarray(data, dtype=np.float64)
    if dither:
        rng = np.random.default_rng(dither_seed)
        # TPDF = sum of two uniform ±0.5 LSB sources, in float domain
        lsb = 1.0 / scale
        x = x + (rng.random(x.shape) + rng.random(x.shape) - 1.0) * lsb
    clipped = np.clip(x, -1.0, 1.0)
    if dither:
        # dither pairs with ROUNDING; the undithered path keeps the
        # reference's truncation semantics byte-for-byte
        ints = np.round(clipped * scale).astype(np.int64)
    else:
        ints = (clipped * scale).astype(np.int64)
    ints = np.clip(ints, -int(scale), int(scale) - 1)
    dtype = {1: np.int8, 2: np.int16, 3: np.int32, 4: np.int32}[sample_width]
    return ints.astype(dtype)


def _unpack_pcm24(raw: bytes) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    out = (b[:, 0].astype(np.int32)
           | (b[:, 1].astype(np.int32) << 8)
           | (b[:, 2].astype(np.int32) << 16))
    return np.where(out >= 1 << 23, out - (1 << 24), out)


def _pack_pcm24(ints: np.ndarray) -> bytes:
    u = np.where(ints < 0, ints + (1 << 24), ints).astype(np.uint32)
    b = np.empty((u.size, 3), dtype=np.uint8)
    b[:, 0] = u & 0xFF
    b[:, 1] = (u >> 8) & 0xFF
    b[:, 2] = (u >> 16) & 0xFF
    return b.tobytes()


def read_wav(path_or_bytes):
    """Read a RIFF/WAVE file → ``(audio float32 (N, C), sample_rate)``."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    elif isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        buf = path_or_bytes.read()

    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    # This is the untrusted-input boundary (workers decode arbitrary
    # uploaded bytes): every malformed header must surface as ValueError —
    # never ZeroDivisionError/struct.error/MemoryError (VERDICT r2 #6).
    pos, end = 12, len(buf)
    fmt = None
    data = None
    while pos + 8 <= end:
        cid, size = buf[pos:pos + 4], struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        body = buf[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("truncated fmt chunk")
            tag, ch, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == WAVE_FORMAT_EXTENSIBLE:
                if len(body) < 26:
                    raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt")
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    tag, ch, rate, bits = fmt
    if ch == 0:
        raise ValueError("fmt chunk declares zero channels")
    if ch > 1024:
        raise ValueError(f"implausible channel count {ch}")
    if rate <= 0:
        raise ValueError(f"invalid sample rate {rate}")

    def _frombuf(raw, dtype, width):
        usable = (len(raw) // width) * width  # tolerate truncated bodies
        return np.frombuffer(raw[:usable], dtype=dtype)

    if tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = _frombuf(data, "<f4", 4).astype(np.float32)
        elif bits == 64:
            x = _frombuf(data, "<f8", 8).astype(np.float32)
        else:
            raise ValueError(f"unsupported IEEE-float bit depth {bits}")
    elif tag == WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.int16) - 128)
            x = pcm_to_float(x, 1)
        elif bits == 16:
            x = pcm_to_float(_frombuf(data, "<i2", 2), 2)
        elif bits == 24:
            usable = (len(data) // 3) * 3
            x = pcm_to_float(_unpack_pcm24(data[:usable]), 3)
        elif bits == 32:
            x = pcm_to_float(_frombuf(data, "<i4", 4), 4)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAVE format tag {tag:#x}")

    n = (x.size // ch) * ch
    return x[:n].reshape(-1, ch), rate


def write_wav(path_or_file, audio, sample_rate, sample_width=2,
              float_format=False, dither=False, dither_seed=None):
    """Write ``(N, C)`` (or ``(N,)``) float audio as WAV.

    ``dither=True`` applies TPDF dither at the PCM quantization (see
    :func:`float_to_pcm`); ignored for ``float_format``."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    ch = audio.shape[1]
    inter = np.ascontiguousarray(audio).reshape(-1)

    if float_format:
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = inter.astype("<f4").tobytes()
    else:
        tag, bits = WAVE_FORMAT_PCM, 8 * sample_width
        ints = float_to_pcm(inter, sample_width, dither=dither,
                            dither_seed=dither_seed)
        if sample_width == 3:
            payload = _pack_pcm24(ints)
        elif sample_width == 1:
            payload = (ints.astype(np.int16) + 128).astype(np.uint8).tobytes()
        else:
            payload = ints.astype("<i%d" % sample_width).tobytes()

    block = ch * (bits // 8)
    hdr = io.BytesIO()
    hdr.write(b"RIFF")
    hdr.write(struct.pack("<I", 36 + len(payload)))
    hdr.write(b"WAVEfmt ")
    hdr.write(struct.pack("<IHHIIHH", 16, tag, ch, sample_rate,
                          sample_rate * block, block, bits))
    hdr.write(b"data")
    hdr.write(struct.pack("<I", len(payload)))
    blob = hdr.getvalue() + payload

    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "wb") as f:
            f.write(blob)
    else:
        path_or_file.write(blob)


_WAV_EXTS = {".wav", ".wave"}


def read_audio(path):
    """Decode a WAV file → ``(float32 (N, C), rate)``."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in _WAV_EXTS:
        raise NotImplementedError(
            f"cannot decode {ext!r}: only WAV is ported (the ffmpeg path is "
            "ROADMAP queue 1 item 4)")
    return read_wav(path)


def write_audio(path, audio, sample_rate, sample_width=2, float_format=False,
                dither=False):
    """Encode a WAV file (``.wav``, ``.wave`` or no extension)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in _WAV_EXTS and ext != "":
        raise NotImplementedError(
            f"cannot encode {ext!r}: only WAV is ported (the ffmpeg path is "
            "ROADMAP queue 1 item 4)")
    write_wav(path, audio, sample_rate, sample_width=sample_width,
              float_format=float_format, dither=dither)
