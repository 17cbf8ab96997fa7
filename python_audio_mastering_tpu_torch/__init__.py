"""python_audio_mastering_tpu_torch — the mastering chain in PyTorch/CUDA.

A port of ``python_audio_mastering_tpu`` (JAX on a TPU, kept as the
reference) to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).  It imports ``torch``, numpy and scipy, never ``jax`` and never
the JAX package, and keeps that package's module layout and function
names.

It runs the worker chain: saturate → 4-band EQ → stereo width →
[3-band multiband compressor] → BS.1770 loudness → gain → soft limiter,
one-shot (:func:`master`) and streamed (``engine.process_audio``).

    >>> from python_audio_mastering_tpu_torch import master, MasteringParams, ChainConfig
    >>> y = master(x, MasteringParams.from_settings({"saturation": 20}),
    ...            ChainConfig.gpu_default(44100), device="cuda")
"""

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import MasteringChain, master
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS

__all__ = ["ChainConfig", "MasteringParams", "EQ_PRESETS", "MasteringChain",
           "master"]
