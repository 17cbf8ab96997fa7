"""Signal ops: filter design, blocked IIR, waveshapers, dynamics, loudness,
meters, resampling and the CUDA kernels (``ops.cuda_multiband``,
``ops.ballistics``).  Re-exports the JAX package's ``ops`` names but its
``sosfilt*`` filters, which the port does not have (ROADMAP queue 1
item 4); the bare ``resample`` function is not re-exported, as it would
shadow the ``ops.resample`` submodule."""

from python_audio_mastering_tpu_torch.ops.biquad import (
    butter_sos,
    deman_high_pass_sos,
    deman_high_shelf_sos,
    rbj_highpass_sos,
    rbj_peak_sos,
    rbj_shelf_sos,
    reference_peak_sos,
    reference_shelf_sos,
    sos_identity,
)
from python_audio_mastering_tpu_torch.ops.iir import (
    cascade_state_space,
    state_to_zi,
    zi_to_state,
)
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    saturate,
    saturate_legacy,
    soft_limiter,
    soft_limiter_legacy,
)
from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
from python_audio_mastering_tpu_torch.ops.loudness import (
    BlockEnergyAccumulator,
    integrated_loudness,
    kweight_sos,
    normalize_to_lufs,
)
from python_audio_mastering_tpu_torch.ops.compressor import (
    compress_dynamic_range,
)
from python_audio_mastering_tpu_torch.ops.multiband import (
    crossover_split,
    multiband_compress,
)
from python_audio_mastering_tpu_torch.ops.meters import (
    loudness_range,
    momentary_loudness,
    shortterm_loudness,
    true_peak_db,
)
from python_audio_mastering_tpu_torch.ops.resample import (
    design_resample_taps,
    resample_poly,
)

__all__ = [
    "reference_shelf_sos", "reference_peak_sos", "rbj_shelf_sos",
    "rbj_peak_sos", "rbj_highpass_sos", "deman_high_shelf_sos",
    "deman_high_pass_sos", "butter_sos", "sos_identity",
    "cascade_state_space", "zi_to_state", "state_to_zi",
    "saturate", "saturate_legacy", "soft_limiter", "soft_limiter_legacy",
    "stereo_width",
    "kweight_sos", "integrated_loudness", "normalize_to_lufs",
    "BlockEnergyAccumulator",
    "compress_dynamic_range", "multiband_compress", "crossover_split",
    "momentary_loudness", "shortterm_loudness", "loudness_range",
    "true_peak_db",
    "design_resample_taps", "resample_poly",
]
