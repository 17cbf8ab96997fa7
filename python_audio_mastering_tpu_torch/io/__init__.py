"""Host-side audio file I/O."""
