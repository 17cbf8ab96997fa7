"""Port modules of the chain: presets and the mastering chain."""
