"""Host-side logging and tracing."""
