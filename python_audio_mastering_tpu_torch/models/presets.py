"""EQ genre presets — values verbatim from the reference worker engine."""

EQ_PRESETS = {
    "techno": {
        "bass_boost": 4.0, "mid_cut": 3.0, "presence_boost": 1.0, "treble_boost": 3.0,
        "description": "Boosted sub-bass and highs, scooped mids for a powerful club sound.",
    },
    "dubstep": {
        "bass_boost": 5.0, "mid_cut": 4.0, "presence_boost": 2.0, "treble_boost": 3.5,
        "description": "Aggressive low-end and crisp highs, with a significant mid-cut.",
    },
    "pop": {
        "bass_boost": 2.0, "mid_cut": 0.0, "presence_boost": 3.5, "treble_boost": 2.5,
        "description": "Focused on vocal clarity with a solid low-end and bright highs.",
    },
    "rock": {
        "bass_boost": 1.5, "mid_cut": -2.0, "presence_boost": 2.5, "treble_boost": 1.0,
        "description": "Warm low-mids for guitars and punchy presence for snare/vocals.",
    },
}

__all__ = ["EQ_PRESETS"]
