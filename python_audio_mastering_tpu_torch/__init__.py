"""python_audio_mastering_tpu_torch — the mastering chain in PyTorch/CUDA.

A port of ``python_audio_mastering_tpu`` (JAX on a TPU, kept as the
reference) to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).  It imports ``torch``, numpy and scipy, never ``jax`` and never
the JAX package, and keeps that package's module layout, function names
and package re-exports.

It runs the worker chain: saturate → 4-band EQ → stereo width →
[3-band multiband compressor] → BS.1770 loudness → gain → soft limiter
(or, in quality mode, the lookahead true-peak limiter), and the legacy
chain of the monolith service (``ChainConfig(variant="legacy")``,
``serving.monolith``), one-shot (:func:`master`), streamed
(``parallel.streaming.master_streamed``, with the R128 meters on
request), by the album (``parallel.batch``, its tracks sharded over the
ranks of a ``parallel.mesh`` mesh when there are several) and sequence
parallel (``parallel.sequence``), and the single-file, album and cloud
engines (``engine``, ``serving``), with output resampling.  The
automaster (``models.automaster``, ``engine.automaster_audio``) fits the
saturation, EQ and width sliders to a reference track by gradient
descent through the chain, on one card or data parallel over ranks;
``cli`` and ``gui`` are the command-line and desktop clients.

    >>> from python_audio_mastering_tpu_torch import master, MasteringParams, ChainConfig
    >>> y = master(x, MasteringParams.from_settings({"saturation": 20}),
    ...            ChainConfig.gpu_default(44100), device="cuda")
"""

from python_audio_mastering_tpu_torch.version import __version__
from python_audio_mastering_tpu_torch.config import (
    ChainConfig,
    CompressorBandParams,
    MasteringParams,
)
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS
from python_audio_mastering_tpu_torch.models.chain import (
    MasteringChain,
    make_master_fn,
    master,
)

__all__ = [
    "__version__",
    "ChainConfig",
    "MasteringParams",
    "CompressorBandParams",
    "EQ_PRESETS",
    "master",
    "make_master_fn",
    "MasteringChain",
]
