"""Host-side audio file I/O."""

from python_audio_mastering_tpu_torch.io.wavio import (
    float_to_pcm,
    pcm_to_float,
    read_audio,
    read_wav,
    write_audio,
    write_wav,
)

__all__ = ["read_wav", "write_wav", "pcm_to_float", "float_to_pcm",
           "read_audio", "write_audio"]
