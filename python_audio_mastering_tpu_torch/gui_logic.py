"""Display-free GUI logic: everything the desktop client does apart from
drawing widgets.

Counterpart of ``python_audio_mastering_tpu.gui_logic`` over the port's
presets (a copy: the port imports nothing of the JAX package).

The reference GUI's behavior (mastering_gui.py) is a handful of pure rules
over slider state: preset application writes the four EQ values
(mastering_gui.py:159-177), ``get_current_settings`` assembles the 13-slider
settings dict plus the ``compress`` key and the long-spelling multiband keys
(mastering_gui.py:179-190), job start validates paths and flips a busy gate
(mastering_gui.py:192-222), and completion is detected by string-matching
"complete"/"error"/"no audio files" in status messages
(mastering_gui.py:224-232).  Extracting them here lets the logic be tested
without a display server; ``gui.MasteringApp`` is a thin Tk shell over this
state.
"""

from __future__ import annotations

import os

from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS

__all__ = ["GuiState", "SLIDERS", "MB_SLIDERS", "AUTOMASTER_KEYS",
           "classify_status", "default_output_path", "EQ_PRESETS"]

# (attr, label, lo, hi, default) — ranges per mastering_gui.py:95-112
SLIDERS = [
    ("saturation", "Saturation (%)", 0.0, 100.0, 0.0),
    ("bass_boost", "Bass (dB)", -6.0, 6.0, 0.0),
    ("mid_cut", "Mid Cut (dB)", 0.0, 6.0, 0.0),
    ("presence_boost", "Presence (dB)", -6.0, 6.0, 0.0),
    ("treble_boost", "Treble (dB)", -6.0, 6.0, 0.0),
    ("width", "Stereo Width", 0.0, 2.0, 1.0),
    ("lufs", "Target LUFS", -24.0, -6.0, -14.0),
]
MB_SLIDERS = [
    ("low_band_threshold", "Low Thresh (dB)", -40.0, 0.0, -25.0),
    ("low_band_ratio", "Low Ratio", 1.0, 12.0, 6.0),
    ("mid_band_threshold", "Mid Thresh (dB)", -40.0, 0.0, -20.0),
    ("mid_band_ratio", "Mid Ratio", 1.0, 12.0, 3.0),
    ("high_band_threshold", "High Thresh (dB)", -40.0, 0.0, -15.0),
    ("high_band_ratio", "High Ratio", 1.0, 12.0, 4.0),
]

_PRESET_EQ_KEYS = ("bass_boost", "mid_cut", "presence_boost", "treble_boost")

# The slider subspace the automaster fit solves for
# (models.automaster._LATENT_SPEC ∩ the GUI sliders).
AUTOMASTER_KEYS = ("saturation", "bass_boost", "mid_cut", "presence_boost",
                   "treble_boost", "width")


def classify_status(message: str) -> str:
    """The reference's completion contract (mastering_gui.py:224-232):
    returns "done", "error", "empty" (no audio files) or "progress"."""
    low = message.lower()
    # "complete" outranks "error": success messages embed the output path
    # ("Processing complete! Saved to <path>"), and a path containing the
    # substring "error" must not demote a successful job (the reference
    # checks "complete" first, mastering_gui.py:226).
    if "complete" in low:
        return "done"
    if "error" in low:
        return "error"
    if "no audio files" in low:
        return "empty"
    return "progress"


def default_output_path(input_path: str) -> str:
    """`{base}_mastered{ext}` next to the input (GUI convenience)."""
    base, ext = os.path.splitext(input_path)
    return f"{base}_mastered{ext}"


class GuiState:
    """The client's parameter/busy state machine, no toolkit required."""

    def __init__(self):
        self.values = {attr: default for attr, _, _, _, default in
                       SLIDERS + MB_SLIDERS}
        self.multiband = False
        self.busy = False
        self.preset = "None"

    # ---------------------------------------------------------- parameters
    def set_value(self, attr: str, value: float):
        if attr not in self.values:
            raise KeyError(attr)
        lo, hi = next((lo, hi) for a, _, lo, hi, _ in SLIDERS + MB_SLIDERS
                      if a == attr)
        self.values[attr] = min(max(float(value), lo), hi)

    def apply_preset(self, name: str):
        """EQ_PRESETS values verbatim; "None" zeroes the four EQ sliders
        (mastering_gui.py:168-176)."""
        self.preset = name
        if name == "None":
            for k in _PRESET_EQ_KEYS:
                self.values[k] = 0.0
            return
        p = EQ_PRESETS[name]
        for k in _PRESET_EQ_KEYS:
            self.values[k] = float(p.get(k, 0.0))

    def get_current_settings(self) -> dict:
        """The 15-key wire dict of mastering_gui.py:179-190: 13 sliders,
        the multiband switch, and the emitted-but-unused ``compress``."""
        s = dict(self.values)
        s["multiband"] = bool(self.multiband)
        s["compress"] = False  # emitted-but-unused reference key
        return s

    # --------------------------------------------------------------- jobs
    def start_single_job(self, input_file: str, output_file: str):
        """Validate + assemble a single-file job. Returns (settings, error):
        settings is None when validation fails or a job is running."""
        if self.busy:
            return None, "A job is already running."
        if not input_file or not output_file:
            return None, "Please select both an input and an output file."
        settings = self.get_current_settings()
        settings["input_file"] = input_file
        settings["output_file"] = output_file
        self.busy = True
        return settings, None

    def start_batch_job(self, input_folder: str, output_folder: str):
        if self.busy:
            return None, "A job is already running."
        if not input_folder or not output_folder:
            return None, "Please select both an input and an output folder."
        self.busy = True
        return self.get_current_settings(), None

    def start_automaster_job(self, input_file: str, reference_file: str,
                             output_file: str):
        """Validate + assemble an automaster job (input + reference →
        fitted sliders → output).  Returns (settings, error)."""
        if self.busy:
            return None, "A job is already running."
        if not input_file or not reference_file or not output_file:
            return None, ("Please select an input file, a reference track "
                          "and an output file.")
        settings = self.get_current_settings()
        settings["input_file"] = input_file
        settings["reference_file"] = reference_file
        settings["output_file"] = output_file
        self.busy = True
        return settings, None

    def apply_fitted_settings(self, fitted: dict) -> dict:
        """Reflect an automaster fit into the slider state: each fitted
        value in the automaster subspace is clamped to its slider range
        (the GUI contract — e.g. the fit's mid_cut can go to −6 dB but the
        reference slider floor is 0, mastering_gui.py:99).  Returns the
        {key: applied_value} subset for the widgets to display."""
        applied = {}
        for k in AUTOMASTER_KEYS:
            if k in fitted:
                self.set_value(k, float(fitted[k]))
                applied[k] = self.values[k]
        self.preset = "None"
        return applied

    def on_status(self, message: str) -> str:
        """Apply a status message: clears the busy gate on terminal
        messages.  Returns the classification."""
        kind = classify_status(message)
        if kind in ("done", "error", "empty"):
            self.busy = False
        return kind
