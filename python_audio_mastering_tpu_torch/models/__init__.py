"""Port modules of the chain: presets, the mastering chain and the
automaster."""

from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS
from python_audio_mastering_tpu_torch.models.chain import (
    MasterResult,
    make_master_fn,
    master,
)

__all__ = ["EQ_PRESETS", "master", "make_master_fn", "MasterResult"]
